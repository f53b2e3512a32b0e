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
// never -inf.  Keys at positions >= T are masked (p = 0), so no length
// needs padding.  Scores are kept in log2 units (scale * log2(e) folded
// into one multiply, exp2 on the SFU).
//
// Two bodies up to a head width of 128, one a caller instantiates:
//   * the inference body (flash_fwd_narrow_kernel, below): kernel 4 alone
//     and the attention stage of kernel 1 (encoder_layer.cu), every call
//     of flash_attention<false>;
//   * the training body (flash_attention_kernel, after it), kept for
//     flash_attention<true> only: kernel 5's attention stage, which drops
//     the probabilities at site 0 (drop.seed set; the DROP instantiation:
//     l sums the undropped p and o = sum_j drop(p_ij) v_j / l, each mask
//     drawn from the hash of ((b*H + h)*T + i)*T + j at the physical key j,
//     common.cuh, the masks of pallas_encoder_train.py) and, with `lse`,
//     writes each row's log-sum-exp in log2 units, m + log2(l), for kernel
//     6's attention backward.  It keeps its summation order until the a2m
//     gates C5 and C6 (ROADMAP.md) are decided.  The inference dispatch
//     never reaches it.
// Wider heads run wide_attention.cuh's flash_fwd_wide_kernel in both.
//
// What bounds it on an H100: both products, S = q k^T and o += p v, run on
// the tensor cores in 3xTF32 (gemm_tf32x3.cuh: each f32 operand split into
// a TF32 big and small part, big.big + big.small + small.big accumulated in
// f32), which keeps f32-level error (~1e-6 relative) where one TF32 pass
// would be off by ~1e-3 and break the 2e-4 tolerance against the f32
// reference.  At [82, 4, 1201, 64] a call is 121 GFLOP of products against
// 0.40 GB of q, k, v and out: at three passes of the 495 TFLOP/s TF32 rate,
// 0.73 ms, plus ~0.13 ms for its 473M exponentials on the SFUs.  The
// shapes the models ship are small: [82, 4, 81, 64] (the gesture step;
// 27.2 MB, 0.0081 ms by bytes), [6, 4, 197, 128] (the predict CLI) and
// [64, 4, 197, 128] (the t2m evaluation's chains; bytes and operations
// both ~0.031 ms).  There a block walks a few key tiles, and what it pays
// for is the work around the products: landing and splitting each tile,
// the softmax, and the hand-offs between them.
//
// The inference body (flash_fwd_narrow_kernel), designed for Hopper:
//   * a block is one producer warpgroup and NC consumer warpgroups, each
//     consumer 64 query rows of one (batch, head): NC = 2 up to DHP 96 (the
//     block takes both query tiles of a T <= 128 head, so the gesture
//     step's K and V land and are split once a head), 1 above (registers:
//     at DHP 128 a consumer holds q's big parts, 64 a thread, and o, 64);
//     the grid runs over (batch * head, query tile) in one dimension, so
//     B * H is not bounded by the grid's second dimension;
//   * the producer lands each key tile of BK keys (64 up to DHP 64 where T
//     > 128, else 32) by the copy engine: two tensor maps (K and V, 4-d over the
//     head width, T, H and B ordered by stride, so that the packed qkv of
//     the encoder chain is read as it lies), one copy a box of 32 columns
//     x BK rows with the 128-byte swizzle, rows past T and columns past dh
//     filled with zeros by the copy engine, completing on an mbarrier; two
//     raw tiles in flight.  Rows that are not 16-byte aligned (`vec` false,
//     e.g. dh 66) are copied a float at a time by cp.async with zero fill
//     into the same swizzled tiles, in the same kernel;
//   * the producer then splits each landed tile into big and small, once
//     a block, into a ring of two split stages in wgmma's K-major core
//     matrices without swizzle (8 rows x 16 bytes; 128 bytes between the
//     two along K, 256 between 8-row groups: gemm_tf32x3.cuh's
//     descriptors): K as it lies (K-major along the head width), V
//     transposed (K-major along the keys, k permuted: keys 0, 2, 4, 6 of a
//     slice in core matrix 0 and 1, 3, 5, 7 in core 1, wide_attention.cuh's
//     layout).  The swizzle makes both its float4 reads down the keys and
//     its reads along a row free of bank conflicts.  mbarriers hand the
//     stages over: full (128 producer arrivals) and empty (128 NC consumer
//     arrivals);
//   * S = q k^T is wgmma m64nBKk8 TF32, A = q's fragments (mma.sync's
//     m16n8k8 A layout, each warp its 16 rows) split once a block, the big
//     parts held in registers and the small parts in shared memory as an A
//     tile (the small . big pass reads both operands from shared memory),
//     B = the split K; o += p v is wgmma m64nDHPk8 TF32, A = P from
//     registers (the S accumulator of an 8-key slice is its A fragment under
//     the k permutation: elements k = t and t + 4 are the physical keys 2t
//     and 2t + 1), B = the split V, a slice's P split while the last
//     slice's three wgmmas run; every product is three wgmmas, big . small
//     + small . big + big . big, into one f32 accumulator;
//   * the online softmax is a consumer's own: its rows, the quad's
//     shuffles, the last tile's keys past T at -FLT_MAX.
// Shared memory a block in bytes (the raw ring 2 x 2 NB boxes of BK x 128
// bytes, the split ring 2 x 4 BK DHP floats, q's small parts NC x 64 DHP
// floats, 64 of mbarriers, 1024 of slack that aligns the raw ring for the
// swizzle), against the 232,448 a block may use, and registers a thread
// (ptxas, no spill at any width):
//   DHP  16: NC 2, BK 64,  74,816, 96;   BK 32,  42,048, 78;
//   DHP  32: NC 2, BK 64, 115,776, 116;  BK 32,  66,624, 96;
//   DHP  48: NC 2, BK 64, 189,504, 135;  BK 32, 107,584, 115;
//   DHP  64: NC 2, BK 64, 230,464, 153;  BK 32, 132,160, 143;
//   DHP  80: NC 2, BK 32, 173,120, 157;  DHP  96: NC 2, BK 32, 197,696, 153;
//   DHP 112: NC 1, BK 32, 209,984, 177;  DHP 128: NC 1, BK 32, 230,464, 192.
// An SM holds one block (two at DHP 16 with 32-key tiles).  Measured on an
// H100 80GB HBM3 at 700 W (tools/kernel_variants.py narrow, the profiler's
// device time; PERF.md section 6), against this file's training body in the
// same call: 1.5x faster at [82, 4, 81, 64], 1.8x at [82, 4, 1201, 64], 2.5x
// at [6, 4, 197, 128], 1.6x at [64, 4, 197, 128].  Tried and not kept (device
// ms by the same tool, PERF.md section 6): the two warpgroups of a block on
// the same 64 rows, each over half the width with the partial scores added in
// shared memory (3.74 ms at [82, 4, 1201, 64], slower than the training
// body's 2.29); K and V rows by one cp.async.bulk a row (3.19-3.23 ms there,
// against 1.79 with 16-byte cp.async and ~1.2 with the tensor maps: per-copy
// overhead); the next tile's scores queued under a tile's softmax with one
// consumer (0.241 ms at [64, 4, 197, 128] against 0.142: the accumulators'
// hazards); the last tile's scores on half its keys and its p v slices past T
// skipped (branches around wgmma: 0.207 against 0.126); a persistent grid
// streaming a block's units through one pipeline (1.28-1.30 ms at [82, 4,
// 1201, 64] against 1.22); all of a tile's P split first and its p v in one
// group with one consumer (no change); one key tile size up to DHP 64 for
// every length (see flash_narrow_launch); one consumer up to DHP 96 (0.0325
// and 1.66 ms).  What the ablations of kernel_variants.py (narrow_no_*) leave
// is the producer's split and the hand-offs: at [64, 4, 197, 128] without the
// split 0.114 ms of 0.125.
//
// The training body (FlashAttention-2 on mma.sync.m16n8k8 TF32): a block
// of 4 warps owns 64 queries of one (batch, head), a warp 16 query rows, and
// walks the key tiles (64 keys; 16 above DHP 64, for registers) through a
// 3-stage cp.async ring.  A warp's q rows are read from device memory once,
// as A fragments in registers (split into big and small once at DHP <= 64,
// above it kept whole and split as used).  K and V fragments are split as
// they are read from shared memory, k permuted as above, so p stays in
// registers.  Only the last, ragged tile is masked.  Row max and row sum are
// reduced over the 4 threads of a quad with shuffles; the sum is kept per
// thread and reduced once at the end.  Shared rows are padded (K to DHP + 8,
// V to DHP + 4 floats) so every fragment read is free of bank conflicts.
// It issues about five instructions per mma, near the issue limit of the
// mma.sync rate.  Its grid keeps B * H in grid.y (at most 65535).
//
// Each tensor is read through (batch, head, position) strides with the head
// width contiguous: the encoder chain passes its packed [B*T, 3D] qkv and
// its [B*T, D] output, the standalone entry point [B, H, T, D] tensors.
// Any head width: up to 128 both bodies are built for the padded widths
// DHP, every multiple of 16 up to 128, and take the real dh at run time;
// columns dh .. DHP - 1 of K and V read as zeros, q's fragments read those
// columns as zeros, and only the columns below dh are stored: zero columns
// add nothing to q . k and give zero output columns, so the result is that
// of the real width, with the scale dh^-0.5 the caller passes.  Rows are
// copied 16 bytes at a time (the training body) or whole (the inference
// body) where dh and every stride are multiples of 4 floats and the
// pointers 16-byte aligned (`vec`), else one float at a time.
#pragma once

#include <cuda.h>
#include <limits.h>

#include <algorithm>

#include "common.cuh"
#include "mma_tf32x3.cuh"
#include "tma.cuh"
#include "wide_attention.cuh"

namespace {

// ---- wgmma at the inference body's widths -------------------------------- //

// d += a . b for a warpgroup, m64nNk8 TF32, d N / 2 floats a thread
// (mma.sync's accumulator, per n8 tile): wgmma_rs_nN with a from registers
// (mma.sync's m16n8k8 A fragment, each warp its 16 rows) and b N x 8 from
// shared memory through its descriptor; wgmma_ss_nN with both from shared
// memory (a 64 x 8)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n112(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n"
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
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b) {
  static_assert(N % 16 == 0 && N >= 16 && N <= 128, "an instantiated wgmma width");
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 48) wgmma_rs_n48(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, b);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, b);
  else if constexpr (N == 112) wgmma_rs_n112(d, a, b);
  else wgmma_n128(d, a, b);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b) {
  static_assert(N == 32 || N == 64, "an instantiated wgmma width");
  if constexpr (N == 32) wgmma_ss_n32(d, a, b);
  else wgmma_ss_n64(d, a, b);
}

// ---- named barriers -------------------------------------------------------- //

// the `n` threads of one warpgroup wait for each other (barrier `id`, not 0)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---- the inference body ---------------------------------------------------- //

constexpr int kNarrowRows = 64;  // query rows a consumer warpgroup: wgmma's M
constexpr int kBoxCols = 32;     // columns of a tensor copy's box: one 128-byte swizzled row

// The inference body at padded width DHP: NC consumer warpgroups, each its
// own 64 query rows of one (batch, head), beside one producer warpgroup;
// key tiles of BK keys (flash_narrow_launch chooses), landing raw in a ring
// of two stages and split into a ring of two
template <int DHP, int BK_>
struct NarrowTile {
  static constexpr int NC = DHP <= 96 ? 2 : 1;    // consumer warpgroups
  static constexpr int BK = BK_;                  // keys a tile
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int NB = (DHP + kBoxCols - 1) / kBoxCols;  // boxes of a raw row
  static constexpr int kBox = BK * kBoxCols;      // floats of a box: 4 or 8 KB
  static constexpr int kRaw = 2 * NB * kBox;      // K and V, raw
  static constexpr int kStage = 4 * BK * DHP;     // K and V, big and small
  // the raw ring, the split ring, q's small part for each consumer
  static constexpr size_t floats =
      (size_t)2 * kRaw + (size_t)2 * kStage + (size_t)NC * kNarrowRows * DHP;
  // and 6 mbarriers, and the slack that aligns the raw ring to 1024 bytes
  static constexpr size_t smem = floats * sizeof(float) + 64 + 1024;
};

// element (key, col) of a raw tile as the tensor copy lands it: boxes of 32
// columns, a key's 128 bytes a row, its 16-byte chunks swizzled by the key
// (chunk c at c ^ (key % 8)), so that both the split pass's float4 reads
// down the keys and its reads along a row are free of bank conflicts
template <int BK>
__device__ __forceinline__ int raw_at(int key, int col) {
  return (col >> 5) * (BK * kBoxCols) + key * kBoxCols + ((((col >> 2) & 7) ^ (key & 7)) << 2) +
         (col & 3);
}

// grid (B * H * ceil(T / (64 NC))), 128 (NC + 1) threads; head width dh <=
// DHP.  With `vec`, K and V land by the tensor maps tmk and tmv (4-d over
// the head width, then T, H and B in the order `pos_k` / `pos_v` give: bits
// 2i .. 2i + 1 the coordinate slot of T, H, B for i = 0, 1, 2).
template <int DHP, int BK_>
__global__ void __launch_bounds__(NarrowTile<DHP, BK_>::kThreads, 1)
flash_fwd_narrow_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, AttnStrides sq,
                        AttnStrides sk, AttnStrides sv, AttnStrides so, int H, int T, int dh,
                        bool vec, float scale, const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv, int pos_k, int pos_v) {
  using Tile = NarrowTile<DHP, BK_>;
  constexpr int BK = Tile::BK, NC = Tile::NC, NB = Tile::NB, BOX = Tile::kBox;
  constexpr int RAW = Tile::kRaw, STAGE = Tile::kStage;
  constexpr int NSL = BK / 8;  // 8-key slices of a tile
  constexpr int KC = DHP / 8;  // k8 steps of q k^T
  static_assert(DHP % 16 == 0, "the padded head width is a multiple of 16");
  extern __shared__ __align__(16) float smem[];
  float* raws = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023) / 4;  // [2][K, V][NB][BOX]
  float* ring = raws + 2 * RAW;       // [2][K big, K small, V big, V small]
  float* qsm = ring + 2 * STAGE;      // [NC][KC][64 * 8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(qsm + NC * kNarrowRows * DHP);
  uint64_t* landed = bars;            // [2] a raw stage has landed
  uint64_t* full = bars + 2;          // [2] a split stage is written
  uint64_t* empty = bars + 4;         // [2] a split stage is read
  const int rows = kNarrowRows * NC;
  const int qtiles = (T + rows - 1) / rows;
  const int bh = blockIdx.x / qtiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % qtiles) * rows;
  const int wg = threadIdx.x >> 7;  // 0 the producer, 1 .. NC the consumers
  const int ntiles = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier: the roles part here

  if (wg == 0) {
    // the producer: tile i's K and V rows land in raw stage i % 2, two
    // tiles in flight (by the tensor maps: one copy a 32-column box, rows
    // past T and columns past dh read as zeros; or a float at a time by
    // cp.async with zero fill), and are split into split stage i % 2 once
    // the consumers have read tile i - 2 there: K as it lies (K-major along
    // the head width, core 0 of a k8 step its columns 0 .. 3), V transposed
    // (K-major along the keys, k permuted: core 0 the keys 0, 2, 4, 6 of a
    // slice, core 1 keys 1, 3, 5, 7)
    const int tid = threadIdx.x;
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;
    // the coordinate of map slot d (1 .. 3) for T, H, B at `pos`
    auto coord = [&](int pos, int d, int j0) {
      return (pos & 3) == d ? j0 : ((pos >> 2) & 3) == d ? h : b;
    };
    // tile i into raw stage i % 2 (one cp.async group a call, empty past
    // the last tile)
    auto load_tile = [&](int i) {
      float* kraw = raws + (i & 1) * RAW;
      float* vraw = kraw + NB * BOX;
      const int j0 = i * BK;
      if (vec) {
        if (tid == 0 && i < ntiles) {
          uint64_t* bar = &landed[i & 1];
          mbar_arrive_expect_tx(bar, static_cast<uint32_t>(2 * NB * BOX * sizeof(float)));
#pragma unroll
          for (int x = 0; x < NB; ++x) {
            tma_load_4d(kraw + x * BOX, &tmk, kBoxCols * x, coord(pos_k, 1, j0),
                        coord(pos_k, 2, j0), coord(pos_k, 3, j0), bar);
            tma_load_4d(vraw + x * BOX, &tmv, kBoxCols * x, coord(pos_v, 1, j0),
                        coord(pos_v, 2, j0), coord(pos_v, 3, j0), bar);
          }
        }
      } else {
        for (int f = tid; i < ntiles && f < BK * DHP; f += 128) {
          const int r = f / DHP, c = f % DHP;
          const bool in = j0 + r < T && c < dh;
          cp_async4(kraw + raw_at<BK>(r, c), in ? kb + (j0 + r) * sk.t + c : kb, in);
          cp_async4(vraw + raw_at<BK>(r, c), in ? vb + (j0 + r) * sv.t + c : vb, in);
        }
        cp_async_commit();
      }
    };
    load_tile(0);
    load_tile(1);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i & 1;
      const float* kraw = raws + s * RAW;
      const float* vraw = kraw + NB * BOX;
      if (vec) {
        mbar_wait(&landed[s], (i >> 1) & 1);
      } else {
        cp_async_wait<1>();  // tile i's group; tile i + 1's may be in flight
        named_sync(1, 128);
      }
      if (i >= 2) mbar_wait(&empty[s], ((i >> 1) - 1) & 1);
      float* kbig = ring + s * STAGE;
      float* ksmall = kbig + BK * DHP;
      float* vbig = ksmall + BK * DHP;
      float* vsmall = vbig + BK * DHP;
#pragma unroll
      for (int it = 0; it < BK * DHP / 512; ++it) {
        const int f = tid + 128 * it, key = f % BK, c4 = f / BK;  // columns 4 c4 .. + 3
        const int off = (c4 >> 1) * BK * 8 + (key >> 3) * 64 + (c4 & 1) * 32 + (key & 7) * 4;
        store_split4(kbig, ksmall, off, ld4(kraw + raw_at<BK>(key, 4 * c4)));
      }
      // V a column n of an 8-key slice j at a time: its 8 keys read once
      // (key 8 j + r at raw_at(8 j + r, n)), the even keys to core 0 and the
      // odd ones to core 1
#pragma unroll
      for (int it = 0; it < (DHP * NSL + 127) / 128; ++it) {
        const int f = tid + 128 * it, n = f % DHP, j = f / DHP, c = (n >> 2) & 7;
        if (DHP * NSL % 128 != 0 && f >= DHP * NSL) break;
        const float* col = vraw + (n >> 5) * BOX + 8 * j * kBoxCols + (n & 3);
        float x[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) x[r] = col[r * kBoxCols + ((c ^ r) << 2)];
        const int off = j * DHP * 8 + (n >> 3) * 64 + (n & 7) * 4;
        store_split4(vbig, vsmall, off, make_float4(x[0], x[2], x[4], x[6]));
        store_split4(vbig, vsmall, off + 32, make_float4(x[1], x[3], x[5], x[7]));
      }
      fence_proxy_async();  // the split stage to wgmma; the raw reads before the next copies
      mbar_arrive(&full[s]);
      named_sync(1, 128);   // every producer thread has read raw stage s
      load_tile(i + 2);
    }
    return;
  }

  // a consumer: its 64 query rows against every key tile
  const int cw = wg - 1, ct = threadIdx.x - 128 * wg;
  const int lane = ct & 31, wi = ct >> 5, g = lane >> 2, t = lane & 3;
  const int qc = q0 + kNarrowRows * cw, r0 = qc + 16 * wi + g, r1 = r0 + 8;
  const float* qb = q + b * sq.b + h * sq.h;
  float* qs = qsm + cw * KC * 512;  // [KC][64 rows * 8]: wgmma's K-major core matrices
  const float scale_log2 = scale * 1.4426950408889634f;

  // q[r0 | r1] as A fragments (a0, a1 at column t of a k8 step, a2, a3
  // at t + 4), zero past T and dh, split once: the big parts held in
  // registers, the small parts in shared memory as a wgmma A tile
  uint32_t qbig[KC][4];
  auto q_at = [&](int r, int col) -> float {
    return r < T && col < dh ? qb[r * sq.t + col] : 0.0f;
  };
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * wi + g + 8 * (e & 1), col = 8 * c + t + 4 * (e >> 1);
      uint32_t small;
      split_tf32(q_at(qc + row, col), qbig[c][e], small);
      qs[c * 512 + (row >> 3) * 64 + (e >> 1) * 32 + (row & 7) * 4 + t] =
          __uint_as_float(small);
    }
  fence_proxy_async();  // q's small parts to wgmma
  named_sync(2 + cw, 128);

  float o[DHP / 2];
#pragma unroll
  for (int e = 0; e < DHP / 2; ++e) o[e] = 0.0f;
  float m_lo = -FLT_MAX, m_hi = -FLT_MAX, l_lo = 0.0f, l_hi = 0.0f;
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & 1, j0 = i * BK;
    const float* kbig = ring + s * STAGE;
    const float* ksmall = kbig + BK * DHP;
    const float* vbig = ksmall + BK * DHP;
    const float* vsmall = vbig + BK * DHP;
    mbar_wait(&full[s], (i >> 1) & 1);

    // S = q k^T, 64 rows x BK keys over the whole width
    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const uint64_t db = wgmma_desc(kbig + c * BK * 8, 128, 256);
      const uint64_t ds = wgmma_desc(ksmall + c * BK * 8, 128, 256);
      wgmma_rs<BK>(sc, qbig[c], ds);
      wgmma_ss<BK>(sc, wgmma_desc(qs + c * 512, 128, 256), db);
      wgmma_rs<BK>(sc, qbig[c], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // online softmax in log2 units; this thread holds keys 8n + 2t + {0, 1}
    // of rows r0 (sc[4n], sc[4n + 1]) and r1 (sc[4n + 2], sc[4n + 3]); keys
    // past T (the last tile's) score -FLT_MAX, and exp2(-FLT_MAX - m) = 0
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] *= scale_log2;
    if (j0 + BK > T) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        if (j0 + 8 * (e / 4) + 2 * t + (e & 1) >= T) sc[e] = -FLT_MAX;
    }
    float mx_lo = -FLT_MAX, mx_hi = -FLT_MAX;
#pragma unroll
    for (int n = 0; n < NSL; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
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
        sc[4 * n + e] = exp2f(sc[4 * n + e] - mn_lo);
        sc[4 * n + 2 + e] = exp2f(sc[4 * n + 2 + e] - mn_hi);
        sum_lo += sc[4 * n + e];
        sum_hi += sc[4 * n + 2 + e];
      }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int d = 0; d < DHP / 8; ++d) {
      o[4 * d] *= al_lo;
      o[4 * d + 1] *= al_lo;
      o[4 * d + 2] *= al_hi;
      o[4 * d + 3] *= al_hi;
    }

    // o += p v: the S accumulator of key slice n is p's A fragment (a0 =
    // row g key 2t, a1 = row g + 8 key 2t, a2, a3 the keys 2t + 1); a
    // slice's split while the last one runs
    uint32_t p_big[2][4], p_small[2][4];
    reg_fence(o);
#pragma unroll
    for (int n = 0; n < NSL; ++n) {
      const int set = n & 1;
      split_tf32(sc[4 * n], p_big[set][0], p_small[set][0]);
      split_tf32(sc[4 * n + 2], p_big[set][1], p_small[set][1]);
      split_tf32(sc[4 * n + 1], p_big[set][2], p_small[set][2]);
      split_tf32(sc[4 * n + 3], p_big[set][3], p_small[set][3]);
      wgmma_fence();
      const uint64_t db = wgmma_desc(vbig + n * DHP * 8, 128, 256);
      const uint64_t ds = wgmma_desc(vsmall + n * DHP * 8, 128, 256);
      wgmma_rs<DHP>(o, p_big[set], ds);
      wgmma_rs<DHP>(o, p_small[set], db);
      wgmma_rs<DHP>(o, p_big[set], db);
      wgmma_commit();
      wgmma_wait<1>();  // the slice before is read: its registers are free
    }
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      reg_fence(p_big[e]);
      reg_fence(p_small[e]);
    }
    mbar_arrive(&empty[s]);  // this warpgroup has read stage s
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  float* ob = out + b * so.b + h * so.h;
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int d = 0; d < DHP / 8; ++d) {
    const int col = 8 * d + 2 * t;
    store_pair(ob + r0 * so.t + col, o[4 * d] * inv_lo, o[4 * d + 1] * inv_lo, r0 < T, col,
               dh, vec);
    store_pair(ob + r1 * so.t + col, o[4 * d + 2] * inv_hi, o[4 * d + 3] * inv_hi, r1 < T,
               col, dh, vec);
  }
}

// ---- the training body ----------------------------------------------------- //

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

// The tensor map of a [B, H, T, dh] operand read through its strides (rows
// 16-byte aligned: `vec`): 4-d over the head width, then T, H and B in the
// order of their strides, boxes of 32 columns x bk rows with the 128-byte
// swizzle; `pos` gets the map slot (1 .. 3) of T, H and B in bits 0-1,
// 2-3 and 4-5.  A dimension of extent 1 takes any valid stride.
inline cudaError_t row_map(CUtensorMap* map, int& pos, const float* x, const AttnStrides& st,
                           int B, int H, int T, int dh, int bk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long ext[3] = {T, H, B};
  long long str[3] = {st.t, st.h, st.b};
  int ord[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) str[i] = 1LL << 20;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (str[ord[j]] < str[ord[i]]) std::swap(ord[i], ord[j]);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxCols), 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  pos = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ext[ord[i]]);
    strides[i] = static_cast<cuuint64_t>(str[ord[i]]) * sizeof(float);
    if (ord[i] == 0) box[i + 1] = static_cast<cuuint32_t>(bk);
    pos |= (i + 1) << (2 * ord[i]);
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Queues the inference body for padded width DHP, key tiles of BK keys, over
// (batch * head, query tile) in grid.x.
template <int DHP, int BK>
cudaError_t flash_narrow_tiles(const FlashArgs& a, cudaStream_t s) {
  using Tile = NarrowTile<DHP, BK>;
  if (a.drop.seed != nullptr || a.lse != nullptr) return cudaErrorInvalidValue;
  CUtensorMap tmk{}, tmv{};
  int pos_k = 0, pos_v = 0;
  cudaError_t e = cudaSuccess;
  if (a.vec) {
    e = row_map(&tmk, pos_k, a.k, a.sk, a.B, a.H, a.T, a.dh, Tile::BK);
    if (e == cudaSuccess) e = row_map(&tmv, pos_v, a.v, a.sv, a.B, a.H, a.T, a.dh, Tile::BK);
  }
  if (e == cudaSuccess) e = set_smem(flash_fwd_narrow_kernel<DHP, BK>, Tile::smem);
  if (e != cudaSuccess) return e;
  const int rows = kNarrowRows * Tile::NC;
  const long long blocks = (long long)a.B * a.H * ((a.T + rows - 1) / rows);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;  // grid.x
  flash_fwd_narrow_kernel<DHP, BK>
      <<<static_cast<unsigned>(blocks), Tile::kThreads, Tile::smem, s>>>(
          a.q, a.k, a.v, a.out, a.sq, a.sk, a.sv, a.so, a.H, a.T, a.dh, a.vec, a.scale, tmk,
          tmv, pos_k, pos_v);
  return cudaSuccess;
}

// The inference body's key tile: 64 keys up to DHP 64 (half the tiles of
// the two-consumer pipeline's hand-offs over a long row: 1.22-1.23 ms at
// [82, 4, 1201, 64] against 1.43-1.46 with 32), but 32 where T <= 128 (less
// of the last tile past T: 0.0226 ms at the gesture step's [82, 4, 81, 64]
// against 0.0259 with 64); 32 above DHP 64, all that shared memory holds.
// PERF.md section 6 (tools/kernel_variants.py narrow_bk32, narrow_bk64).
template <int DHP>
cudaError_t flash_narrow_launch(const FlashArgs& a, cudaStream_t s) {
  if constexpr (DHP <= 64)
    if (a.T > 128) return flash_narrow_tiles<DHP, 64>(a, s);
  return flash_narrow_tiles<DHP, 32>(a, s);
}

// the training body (with site-0 dropout where drop.seed is set) for
// TRAIN, the inference body otherwise
template <int DHP, bool TRAIN>
cudaError_t flash_dhp(const FlashArgs& a, cudaStream_t s) {
  if constexpr (TRAIN) {
    if (a.drop.seed != nullptr) return flash_launch<DHP, true>(a, s);
    return flash_launch<DHP, false>(a, s);
  } else {
    return flash_narrow_launch<DHP>(a, s);
  }
}

// Queues the flash forward on `s` for any head width dh <= 128 (the body of
// the next multiple of 16: the training body for TRAIN, the inference body
// otherwise), wide_attention.cuh's flash_wide_launch for wider heads, with
// site-0 dropout when drop.seed is set (TRAIN: the training layer's
// instantiation; the inference ones build no dropout kernel) and the rows'
// log-sum-exp (log2 units, [B*H, T]) when lse is not null (TRAIN only).
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
