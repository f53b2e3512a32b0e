// The local block in whole rows: a variant of csrc/local_block.cu that
// tools/kernel_variants.py builds in its place ("local_rows") and times
// against it.  It lost (0.0213 against 0.0158 ms device time at
// [82,80,256] on an H100, PERF.md section 6), so it is not shipped.
//
// MDM-V2 pre-encoder local block, inference path, float32.
//
// Replaces: gesturediffusion_tpu/ops/pallas_local_block.py::_local_block_kernel
// (reached through fused_local_block).  Same function, per batch row b and
// head h of width dh = D / H (rotary is the half-split convention):
//
//   r       = rope(x[b, :, h], positions 0..T-1)      q = k = v = r
//   a[i]    = softmax_j(r[i] . r[j] / sqrt(dh)) r[j]   over j in
//             [max(0, (i / w - 1) * w), i]             (f32 softmax)
//   out[b, 0, h]     = rope(coa[b, h], position 0)
//   out[b, i + 1, h] = rope(a[i], position i + 1)
//
// What bounds it on an H100: at the gesture shape (B=82, T=80, D=256,
// 8 heads of 32, w=10) a call moves ~13.6 MB (x and coa in, [B, T+1, D]
// out) and does ~0.1 GFLOP: it is bound by memory bandwidth, ~4 us at
// 3.35 TB/s.
//
// Design: the TPU kernel kept [block_b, T, 256] in VMEM and paid for the
// TPU's (8, 128) tiling with a rotate-half permutation matmul, static lane
// slices and rows padded to 8.  None of that carries over.  Here the unit
// of work is one batch row's 16-query tile with all its heads: 410 units at
// the gesture shape.  A persistent grid of as many blocks as the card holds
// at once (one wave) walks them, unit blockIdx.x, then + gridDim.x, ...  A
// unit's rows, the band of its 16 queries (at most 2w + 15, rounded up to
// 8), arrive as whole D-float rows of x, one bulk copy (the TMA engine) a
// row, into one of two shared slabs, completing on that slab's mbarrier;
// warp 0 starts the next unit's copies before the block waits for this
// unit's, so the copy overlaps this unit's work.  The block applies the
// first rotary pass in place, then each warp runs the band attention of
// one head on the tensor cores (band_tile.cuh, shared with
// band_attention.cu: 3xTF32 mma.sync, the band mask in registers, P in
// registers) straight from the whole rows (head h at column h dh, so at a
// head width below DHP it would read the next head's columns: this variant
// is right only where dh is a multiple of 16).  Each warp parks its output rows
// in shared memory and the block applies the second rotary pass and writes
// the tile's output rows, whole rows, and the conditioning token with the
// first tile.  A row of the slab is D floats padded to a stride of 4 mod
// 32 floats, so band_tile's fragment reads are free of bank conflicts; the
// padding and the slabs' unloaded rows are zeroed once, so every value
// band_tile reads is finite.  The rotary tables (cos and sin of the
// float32 frequencies of models/embeddings.py::rotary_freqs, [T + 1,
// dh / 2]) are built once per shape and device by the wrapper and read from
// L2 (10 KB at the gesture shape).  The products of rope are rounded as
// PyTorch's (no fused multiply-add), so rope here is bit for bit the plain
// version's.

#include <algorithm>

#include "band_tile.cuh"

namespace {

// generic-proxy shared-memory writes ordered before later accesses of the
// async proxy (bulk copies into the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- bulk copies (the TMA engine) and their mbarriers -------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier that completes a phase on `count` arrivals and
// the bytes they expect; then mbar_init_fence, then a block barrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of bulk copies on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// waits for the completion of the barrier's phase of parity `parity` (its
// n-th phase has parity n % 2)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared by
// the TMA engine, completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

constexpr int kLocalWarps = 8;
constexpr int kLocalThreads = 32 * kLocalWarps;
constexpr int kTileQ = 16;  // queries a unit

// rope of the pair (x1, x2) = (column k, column k + dh / 2) with cos c and
// sin s: x * cos + rotate_half(x) * sin, each product rounded on its own
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

// Rope over `n` rows of `src` (row stride lds; positions pos0, pos0 + 1,
// ...) into `dst` (row stride ldd), all H heads: in place when dst = src.
// `vec`: dh % 8 == 0 and 16-byte aligned rows, a float4 of each half a
// thread.
__device__ __forceinline__ void rope_rows(float* dst, long long ldd, const float* src,
                                          long long lds, int n, int pos0, int H, int dh,
                                          const float* cos_t, const float* sin_t, bool vec) {
  const int half = dh / 2;
  if (vec) {
    const int h4 = half / 4, per_row = H * h4;
    for (int f = threadIdx.x; f < n * per_row; f += blockDim.x) {
      const int r = f / per_row, p = f - r * per_row, h = p / h4, k = (p - h * h4) * 4;
      const int c = h * dh + k, tab = (pos0 + r) * half + k;
      float4 y1, y2;
      rope4(ld4(src + r * lds + c), ld4(src + r * lds + c + half), ld4(cos_t + tab),
            ld4(sin_t + tab), y1, y2);
      *reinterpret_cast<float4*>(dst + r * ldd + c) = y1;
      *reinterpret_cast<float4*>(dst + r * ldd + c + half) = y2;
    }
  } else {
    const int per_row = H * half;
    for (int f = threadIdx.x; f < n * per_row; f += blockDim.x) {
      const int r = f / per_row, p = f - r * per_row, h = p / half, k = p - h * half;
      const int c = h * dh + k, tab = (pos0 + r) * half + k;
      float y1, y2;
      rope_pair(src[r * lds + c], src[r * lds + c + half], cos_t[tab], sin_t[tab], y1, y2);
      dst[r * ldd + c] = y1;
      dst[r * ldd + c + half] = y2;
    }
  }
}

struct LocalArgs {
  const float *x, *coa, *cos_t, *sin_t;  // [B, T, D], [B, D], [T + 1, dh / 2] x 2
  float* out;                            // [B, T + 1, D]
  int T, D, H, window;
  float scale_log2;  // dh^-0.5 * log2(e)
  bool vec;          // dh % 8 == 0: float4 rope passes
  int ld;            // slab row stride in floats: >= D + DHP - dh, 4 mod 32
  int rows;          // rows a unit stages: its band, rounded up to 8
  int ntiles;        // 16-query tiles of a batch row
  int units;         // B * ntiles
};

// grid min(units, one wave); block kLocalThreads.  Unit u: batch row
// u / ntiles, queries 16 (u % ntiles) + [0, 16).
template <int DHP>
__global__ void __launch_bounds__(kLocalThreads, 2) local_block_kernel(LocalArgs a) {
  constexpr int NO = DHP / 8;
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [2], one a slab
  const int T = a.T, D = a.D, H = a.H, dh = D / H, ld = a.ld, w = a.window;
  const int slab = a.rows * ld;
  float* slabs = smem + 4;          // [2][rows][ld] whole rows of x, then rope(x)
  float* os = slabs + 2 * slab;     // [16][ld] the unit's attention rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int f = threadIdx.x; f < 2 * slab; f += kLocalThreads) slabs[f] = 0.0f;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  fence_proxy_async();  // the zeros before the bulk copies' writes
  __syncthreads();

  // warp 0: the rows [k0, min(k0 + rows, T)) of unit u into slab s
  auto fetch = [&](int u, int s) {
    const int b = u / a.ntiles, k0 = band_lo((u % a.ntiles) * kTileQ, w);
    const int n = min(k0 + a.rows, T) - k0;
    if (lane == 0) mbar_arrive_expect_tx(&bar[s], static_cast<uint32_t>(n * D * 4));
    __syncwarp();
    for (int r = lane; r < n; r += 32)
      bulk_copy_g2s(slabs + s * slab + r * ld, a.x + ((size_t)b * T + k0 + r) * D, D * 4,
                    &bar[s]);
  };
  if (warp == 0) fetch(blockIdx.x, 0);

  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++it) {
    const int s = it & 1;
    // slab s ^ 1 was last read before the previous unit's second barrier
    if (warp == 0 && u + gridDim.x < a.units) fetch(u + gridDim.x, s ^ 1);
    mbar_wait(&bar[s], (it >> 1) & 1);
    const int b = u / a.ntiles, q0 = (u % a.ntiles) * kTileQ, k0 = band_lo(q0, w);
    float* xs = slabs + s * slab;

    // the first rotary pass in place, positions k0 ..
    rope_rows(xs, ld, xs, ld, min(k0 + a.rows, T) - k0, k0, H, dh, a.cos_t, a.sin_t, a.vec);
    fence_proxy_async();  // these writes before the bulk copy that refills the slab
    __syncthreads();

    // the band attention, q = k = v, a warp a head
    for (int h = warp; h < H; h += kLocalWarps) {
      auto row = [&](int j) { return xs + (j - k0) * ld + h * dh; };
      float o[NO][4];
      band_tile<DHP>(q0, T, w, a.scale_log2, row, row, row, o);
#pragma unroll
      for (int d = 0; d < NO; ++d) {
        const int col = 8 * d + 2 * t;  // dh is even: col < dh holds col + 1 < dh
        if (col >= dh) continue;
        float* p = os + g * ld + h * dh + col;
        *reinterpret_cast<float2*>(p) = make_float2(o[d][0], o[d][1]);
        *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(o[d][2], o[d][3]);
      }
    }
    __syncthreads();

    // the second rotary pass, positions q0 + 1 .., and the token at 0
    float* outb = a.out + (size_t)b * (T + 1) * D;
    rope_rows(outb + (size_t)(q0 + 1) * D, D, os, ld, min(kTileQ, T - q0), q0 + 1, H, dh,
              a.cos_t, a.sin_t, a.vec);
    if (q0 == 0) rope_rows(outb, D, a.coa + (size_t)b * D, D, 1, 0, H, dh, a.cos_t, a.sin_t,
                           a.vec);
  }
}

template <int DHP>
cudaError_t local_block_launch(LocalArgs a, int B, cudaStream_t s) {
  const int dh = a.D / a.H;
  // a stride of 4 mod 32 floats with room for the last head's DHP columns
  a.ld = a.D + (DHP - dh);
  a.ld += ((4 - a.ld % 32) % 32 + 32) % 32;
  a.rows = (2 * a.window + kTileQ - 1 + 7) / 8 * 8;
  a.ntiles = (a.T + kTileQ - 1) / kTileQ;
  a.units = B * a.ntiles;
  const size_t smem = (4 + (2 * (size_t)a.rows + kTileQ) * a.ld) * sizeof(float);
  int blocks = 0;
  const cudaError_t e = wave_blocks(local_block_kernel<DHP>, kLocalThreads, smem, blocks);
  if (e != cudaSuccess) return e;
  local_block_kernel<DHP><<<std::min(blocks, a.units), kLocalThreads, smem, s>>>(a);
  return cudaSuccess;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, T, D] and coa [B, D] contiguous and 16-byte aligned, D % 4 == 0,
// cos_t and sin_t [T + 1, dh / 2] (dh = D / H even, at most 128) -> out
// [B, T + 1, D].  Returns cudaGetLastError() after queueing the block on
// `stream`.
int gdt_local_block_f32(const float* x, const float* coa, const float* cos_t,
                        const float* sin_t, float* out, float* /* ws: unused */, int B, int T,
                        int D, int H, int window, float scale, void* stream) {
  const int dh = D / H;
  if (B < 1 || T < 1 || D % H || D % 4 || dh % 2 || window < 1 || !aligned(x) || !aligned(coa))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = dh % 8 == 0 && aligned(cos_t) && aligned(sin_t) && aligned(out);
  LocalArgs a{x, coa, cos_t, sin_t, out, T, D, H, window, scale * 1.4426950408889634f, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = with_padded_width(
      dh, [&](auto w) { return local_block_launch<decltype(w)::value>(a, B, s); });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
