// Causal banded local attention, look-back one window, float32.
//
// Replaces: gesturediffusion_tpu/ops/pallas_attention.py::_band_kernel
// (reached through local_attention_pallas / local_attention_auto above 256
// frames).  Same function, per (batch, head) and query i, window w:
//
//   out[i] = softmax_j(q[i] . k[j] * scale) v[j]   over j in
//            [max(0, (i / w - 1) * w), i]           (f32 scores and softmax)
//
// i.e. the keys j <= i of the query's own window and of the previous one;
// the first window has no previous one.  q, k and v are three pointers,
// each read through its own (batch, head, position) strides with the head
// width contiguous, so the local block's rotated heads (a transposed view
// of [B, T, H, dh]) are read in place: no repacking copy.
//
// What bounds it on an H100: at the long-chunk shape [82, 8, 1200, 32]
// (w 10) a call does ~1.6 GFLOP (at most 2w keys a query) against ~0.2 GB
// of compulsory traffic when q = k = v, as in the local block (the input
// read once, the output written once): ~8 FLOP per byte, bound by memory
// bandwidth, ~0.06 ms at 3.35 TB/s.
//
// Design: the TPU kernel took a query block of BQ rows (a multiple of w)
// with its own and the previous aligned KV block, [BQ, 2 BQ] score tiles on
// the MXU, a mask from broadcast iotas and a joint softmax.  Its masked
// tiles are mostly wasted work, and the MXU tiling does not carry over.
// Here one block owns one (batch * head, tile of kTile queries): it stages
// the tile's queries and the K / V rows its band reaches (at most kTile +
// 2w - 1 of them) into shared memory, so nothing grows with T; then one
// warp per query computes only the <= 2w band scores (lanes over keys, K
// rows padded to dh + 1 floats so those reads fall in distinct banks), the
// softmax with warp reductions, starting from the finite -FLT_MAX (never
// -inf), and the weighted sum of V (lanes over the head width), and writes
// the output row once.  Keys outside the band are never scored, which is
// the same as masking them.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // queries per block

__device__ __forceinline__ const float* row_ptr(const float* p, const AttnStrides& s, int b,
                                                int h, int t) {
  return p + b * s.b + h * s.h + t * s.t;
}

// grid (B * H, ceil(T / kTile)); dh % 4 == 0, rows 16-byte aligned
__global__ void __launch_bounds__(kThreads)
band_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      AttnStrides sq, AttnStrides sk, AttnStrides sv, AttnStrides so,
                      int H, int T, int dh, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kTile;
  const int rows = min(kTile, T - q0);
  const int k_lo = max(0, (q0 / window - 1) * window);
  const int nkeys = q0 + rows - k_lo;
  const int ks = dh + 1, nwarps = kThreads / 32;
  float* Qs = smem;                 // [kTile][dh]
  float* Vs = Qs + kTile * dh;      // [kTile + 2w][dh]
  float* Ks = Vs + (kTile + 2 * window) * dh;  // [kTile + 2w][dh + 1]
  float* pbuf = Ks + (kTile + 2 * window) * ks;  // [nwarps][2w]

  const int dh4 = dh / 4;
  for (int idx = threadIdx.x; idx < rows * dh4; idx += blockDim.x) {
    const int r = idx / dh4, d = (idx - r * dh4) * 4;
    *reinterpret_cast<float4*>(Qs + r * dh + d) =
        *reinterpret_cast<const float4*>(row_ptr(q, sq, b, h, q0 + r) + d);
  }
  for (int idx = threadIdx.x; idx < nkeys * dh4; idx += blockDim.x) {
    const int r = idx / dh4, d = (idx - r * dh4) * 4;
    const float4 k4 = *reinterpret_cast<const float4*>(row_ptr(k, sk, b, h, k_lo + r) + d);
    float* kr = Ks + r * ks + d;
    kr[0] = k4.x; kr[1] = k4.y; kr[2] = k4.z; kr[3] = k4.w;
    *reinterpret_cast<float4*>(Vs + r * dh + d) =
        *reinterpret_cast<const float4*>(row_ptr(v, sv, b, h, k_lo + r) + d);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = pbuf + warp * 2 * window;
  for (int r = warp; r < rows; r += nwarps) {
    const int i = q0 + r;
    const int lo = max(0, (i / window - 1) * window);
    const int nk = i - lo + 1;  // <= 2w
    const float* qi = Qs + r * dh;
    const float* kb = Ks + (lo - k_lo) * ks;
    float m = -FLT_MAX;
    for (int jj = lane; jj < nk; jj += 32) {
      const float* kj = kb + jj * ks;
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qi[d], kj[d], s);
      s *= scale;
      p[jj] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int jj = lane; jj < nk; jj += 32) {
      const float e = expf(p[jj] - m);
      p[jj] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    __syncwarp();
    const float* vb = Vs + (lo - k_lo) * dh;
    float* orow = out + b * so.b + h * so.h + i * so.t;
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.0f;
      for (int jj = 0; jj < nk; ++jj) acc = fmaf(p[jj], vb[jj * dh + d], acc);
      orow[d] = acc * inv;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out [B, H, T, dh] through their strides (in floats, head width
// contiguous).  Returns cudaGetLastError() after queueing on `stream`.
int gdt_band_attention_f32(const float* q, const float* k, const float* v, float* out,
                           long long qb, long long qh, long long qt, long long kb,
                           long long kh, long long kt, long long vb, long long vh,
                           long long vt, long long ob, long long oh, long long ot,
                           int B, int H, int T, int dh, int window, float scale,
                           void* stream) {
  if (dh % 4 != 0 || window < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nwarps = kThreads / 32;
  const size_t keys = kTile + 2 * (size_t)window;
  const size_t smem =
      ((size_t)kTile * dh + keys * dh + keys * (dh + 1) + nwarps * 2 * (size_t)window) *
      sizeof(float);
  const cudaError_t e = set_smem(band_attention_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (T + kTile - 1) / kTile);
  band_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, AttnStrides{qb, qh, qt}, AttnStrides{kb, kh, kt},
      AttnStrides{vb, vh, vt}, AttnStrides{ob, oh, ot}, H, T, dh, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
