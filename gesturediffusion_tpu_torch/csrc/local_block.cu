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
// out) and does ~0.1 GFLOP, ~8 FLOP per byte: it is bound by memory
// bandwidth, ~4 us at 3.35 TB/s.
//
// Design: the TPU kernel kept [block_b, T, 256] in VMEM and paid for the
// TPU's (8, 128) tiling with a rotate-half permutation matmul, static lane
// slices and rows padded to 8.  None of that carries over.  Here one block
// owns one (batch, head) pair: it reads the head's [T, dh] slice once,
// applies the first rotary pass while staging it into shared memory, runs
// the banded attention from shared memory (one warp per query row, lanes
// over the <= 2w keys for the scores, lanes over dh for the weighted sum),
// applies the second rotary pass in registers and writes the output row
// once.  The rotary tables are computed per block into shared memory from
// the same float64 frequencies the reference builds on the host.  Every
// input byte is read from device memory once and every output byte written
// once.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100 per-block opt-in maximum

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x [B, T, D], coa [B, D] -> out [B, T + 1, D]; one block per (batch, head)
__global__ void __launch_bounds__(kThreads)
local_block_kernel(const float* __restrict__ x, const float* __restrict__ coa,
                   float* __restrict__ out, int T, int D, int H, int window,
                   float scale) {
  extern __shared__ float smem[];
  const int dh = D / H, half = dh / 2, xs_stride = dh + 1;
  const int nwarps = blockDim.x >> 5;
  float* xs = smem;                     // [T][dh + 1] rotated head slice
  float* cs = xs + T * xs_stride;       // [T + 1][half] cos table
  float* sn = cs + (T + 1) * half;      // [T + 1][half] sin table
  float* obuf = sn + (T + 1) * half;    // [nwarps][dh] attention row
  float* pbuf = obuf + nwarps * dh;     // [nwarps][T] softmax weights
  const int b = blockIdx.x / H, h = blockIdx.x % H;

  // rotary tables: freq = float32(pos * 10000^(-2k/dh)) computed in float64
  // (models/embeddings.py::rotary_freqs), then cos / sin in float32
  for (int idx = threadIdx.x; idx < (T + 1) * half; idx += blockDim.x) {
    const int pos = idx / half, k = idx - pos * half;
    const double inv = 1.0 / pow(10000.0, (double)(2 * k) / (double)dh);
    const float f = (float)((double)pos * inv);
    cs[idx] = cosf(f);
    sn[idx] = sinf(f);
  }
  __syncthreads();

  const float* xb = x + (size_t)b * T * D + h * dh;
  for (int idx = threadIdx.x; idx < T * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    const bool lo_half = d < half;
    const int k = lo_half ? d : d - half;
    const float v = xb[(size_t)i * D + d];
    const float partner = xb[(size_t)i * D + (lo_half ? d + half : d - half)];
    const float rh = lo_half ? -partner : partner;
    xs[i * xs_stride + d] = v * cs[i * half + k] + rh * sn[i * half + k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ob = obuf + warp * dh;
  float* p = pbuf + warp * T;
  float* outb = out + (size_t)b * (T + 1) * D + h * dh;

  for (int i = warp; i < T; i += nwarps) {
    int lo = (i / window - 1) * window;
    if (lo < 0) lo = 0;
    const int nk = i - lo + 1;
    const float* qi = xs + i * xs_stride;
    float m = -FLT_MAX;
    for (int jj = lane; jj < nk; jj += 32) {
      const float* kj = xs + (lo + jj) * xs_stride;
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
    sum = warp_sum(sum);
    const float inv = 1.0f / sum;
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.0f;
      for (int jj = 0; jj < nk; ++jj)
        acc = fmaf(p[jj], xs[(lo + jj) * xs_stride + d], acc);
      ob[d] = acc * inv;
    }
    __syncwarp();
    const int pos = i + 1;
    for (int d = lane; d < dh; d += 32) {
      const bool lo_half = d < half;
      const int k = lo_half ? d : d - half;
      const float rh = lo_half ? -ob[d + half] : ob[d - half];
      outb[(size_t)pos * D + d] =
          ob[d] * cs[pos * half + k] + rh * sn[pos * half + k];
    }
    __syncwarp();
  }

  // row 0: the conditioning token, rotated at position 0
  if (warp == nwarps - 1) {
    const float* cb = coa + (size_t)b * D + h * dh;
    for (int d = lane; d < dh; d += 32) {
      const bool lo_half = d < half;
      const int k = lo_half ? d : d - half;
      const float rh = lo_half ? -cb[d + half] : cb[d - half];
      outb[d] = cb[d] * cs[k] + rh * sn[k];
    }
  }
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after queueing the block on `stream`.
int gdt_local_block_f32(const float* x, const float* coa, float* out, int B,
                        int T, int D, int H, int window, float scale,
                        void* stream) {
  const int dh = D / H;
  const int nwarps = kThreads / 32;
  const size_t smem = ((size_t)T * (dh + 1) + 2 * (size_t)(T + 1) * (dh / 2) +
                       (size_t)nwarps * (dh + T)) *
                      sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  local_block_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, coa, out, T, D, H, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
