// The 3xTF32 primitives every tensor-core kernel of the port shares: TF32
// rounding and the big + small split of an f32 operand, mma.sync.m16n8k8
// TF32 in one and in three passes, and the cp.async copies that feed them
// (gemm_tf32x3.cuh, flash_attention.cuh, encoder_layer_train.cu,
// band_tile.cuh).  Why three passes: gemm_tf32x3.cuh.
#pragma once

#include <stdint.h>

namespace {

// ---- 3xTF32 primitives --------------------------------------------------- //

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as its bits:
// half a TF32 ulp added to the magnitude bits, the low 13 cleared.  The same
// rounding as cvt.rna.tf32.f32 for finite x in two integer operations,
// which measured faster on an H100 than the conversion instruction, whose
// throughput is lower (the split rounds every operand element twice).
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small to ~2^-22 relative; x - big is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rn(x);
  small = tf32_rn(x - __uint_as_float(big));
}

// d += a . b on one m16n8k8 tile, TF32 operands, f32 accumulator.
// a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, col g), b1 (t + 4, g); d0, d1 (row g, cols 2t, 2t + 1), d2, d3
// (row g + 8); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32: the two small cross terms first, then big . big
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_big);
}

// ---- cp.async ------------------------------------------------------------ //

// 16 bytes global -> shared, or 16 zero bytes when !in (src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

// one float global -> shared, or a zero when !in: the copy of rows that are
// not 16-byte aligned (a head width not divisible by 4)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Rows [r0, r0 + n) of a [T, dh] operand (row stride ld floats) into n
// shared rows of LD floats, DHP columns: one float a copy, rows past T and
// columns past dh zero-filled.  The copy of rows that are not 16-byte
// aligned (dh % 4 != 0); kept out of line so that the kernels' main loops
// hold only their float4 copies.
template <int DHP, int LD>
__device__ __noinline__ void copy_rows_scalar(float* dst, const float* src, long long ld, int r0,
                                              int n, int T, int dh) {
  for (int f = threadIdx.x; f < n * DHP; f += blockDim.x) {
    const int r = f / DHP, c = f % DHP;
    const bool in = r0 + r < T && c < dh;
    cp_async4(dst + r * LD + c, in ? src + (r0 + r) * ld + c : src, in);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
