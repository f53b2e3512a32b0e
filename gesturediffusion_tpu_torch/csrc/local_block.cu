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
// 3.35 TB/s.  The call is two waves of small blocks, so what it costs is
// two blocks' latency: load, attention, store, in series.
//
// Design: the TPU kernel kept [block_b, T, 256] in VMEM and paid for the
// TPU's (8, 128) tiling with a rotate-half permutation matmul, static lane
// slices and rows padded to 8.  None of that carries over.  Here one block
// owns one (batch, head) pair, 656 blocks at the gesture shape.  At DHP 32
// a block has up to 5 warps and registers capped for 4 blocks an SM (528
// at once: two waves; uncapped, 3 an SM fit, and the call measured 5%
// slower); wider heads spill under that cap and run faster in blocks of up
// to 16 warps, uncapped.  Each 128-byte head row a block
// reads is one whole cache line.  A persistent one-wave grid over (batch
// row, 16-query tile) units that loads whole 1 KB rows of x by the TMA
// engine into two slabs measured slower (tools/variants/local_block_rows.cu,
// PERF.md section 6): each unit re-ropes its band's halo rows, and its
// passes serialize within the block.  The block reads the
// head's [T, dh] slice once, applying the first rotary pass on the way into
// shared memory (a float4 from each half a thread, columns past dh zeroed),
// then each warp runs the band attention of 16 queries on the tensor cores
// (band_tile.cuh, shared with band_attention.cu: 3xTF32 mma.sync, the band
// mask in registers, P in registers), a warp a tile (5 warps at T 80),
// parks its output rows in shared memory, and the block applies the second
// rotary pass and writes the T + 1 output rows, the conditioning token
// first, a float4 a thread.  The rotary tables (cos and sin of the float32
// frequencies of models/embeddings.py::rotary_freqs, [T + 1, dh / 2]) are
// built once per shape and device by the wrapper and read from L2 (10 KB at
// the gesture shape).  The products of rope are rounded as PyTorch's
// (no fused multiply-add), so rope here is bit for bit the plain version's.
// A head whose rows do not fit a block's shared memory (local heads wider
// than 128, or 128 past 216 frames) takes wide_attention.cuh's
// local_block_wide_kernel up to local heads of 272: one launch, no
// workspace, 64 queries a block over the whole width, x's rows roped as
// they land, the band's scores once, the output tile staged in shared
// memory for the second rotary pass and the token.  Wider heads take three
// launches: the first rotary pass into a workspace, the band kernel of
// wide_attention.cuh on it, and the token and second rotary pass.

#include <algorithm>

#include "band_tile.cuh"
#include "wide_attention.cuh"

namespace {

// the most warps a block, a 16-query tile a warp (5 at T 80); see above
template <int DHP>
constexpr int kMaxLocalWarps = DHP <= 32 ? 5 : 16;

struct LocalArgs {
  const float *x, *coa, *cos_t, *sin_t;  // [B, T, D], [B, D], [T + 1, dh / 2] x 2
  float* out;                            // [B, T + 1, D]
  int T, D, H, window;
  float scale_log2;  // dh^-0.5 * log2(e)
  bool vec;          // dh % 8 == 0 and 16-byte aligned rows: float4 copies
};

// grid B * H, block 32 x min(kMaxLocalWarps, ceil(T / 16))
template <int DHP>
__global__ void __launch_bounds__(32 * kMaxLocalWarps<DHP>, DHP <= 32 ? 4 : 1)
    local_block_kernel(LocalArgs a) {
  constexpr int LD = DHP + 4, NO = DHP / 8;
  extern __shared__ __align__(16) float smem[];
  const float *__restrict__ x = a.x, *__restrict__ cos_t = a.cos_t, *__restrict__ sin_t = a.sin_t;
  const int T = a.T, D = a.D, H = a.H, dh = D / H, half = dh / 2, nthreads = blockDim.x;
  const bool vec = a.vec;
  float* xs = smem;               // [T + 8][LD] rotated rows; columns past dh, rows past T zero
  float* os = xs + (T + 8) * LD;  // [T][LD] attention rows
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* xb = x + (size_t)b * T * D + h * dh;

  // the first rotary pass, positions 0 .. T - 1, on the way in
  if (vec) {
    const int h4 = half / 4;
    for (int f = threadIdx.x; f < T * h4; f += nthreads) {
      const int i = f / h4, k = (f - i * h4) * 4;
      float4 y1, y2;
      rope4(ld4(xb + (size_t)i * D + k), ld4(xb + (size_t)i * D + k + half),
            ld4(cos_t + i * half + k), ld4(sin_t + i * half + k), y1, y2);
      *reinterpret_cast<float4*>(xs + i * LD + k) = y1;
      *reinterpret_cast<float4*>(xs + i * LD + k + half) = y2;
    }
  } else {
    for (int f = threadIdx.x; f < T * half; f += nthreads) {
      const int i = f / half, k = f - i * half;
      rope_pair(xb[(size_t)i * D + k], xb[(size_t)i * D + k + half], cos_t[i * half + k],
                sin_t[i * half + k], xs[i * LD + k], xs[i * LD + k + half]);
    }
  }
  // the padded columns, and the 8 rows past T that band_tile.cuh may read
  for (int f = threadIdx.x; f < T * (DHP - dh); f += nthreads) {
    const int i = f / (DHP - dh);
    xs[i * LD + dh + (f - i * (DHP - dh))] = 0.0f;
  }
  for (int f = threadIdx.x; f < 8 * LD; f += nthreads) xs[T * LD + f] = 0.0f;
  __syncthreads();

  // the band attention, q = k = v, a warp a 16-query tile
  const int warp = threadIdx.x >> 5, nwarps = nthreads >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto row = [&](int j) { return xs + j * LD; };
  for (int q0 = 16 * warp; q0 < T; q0 += 16 * nwarps) {
    float o[NO][4];
    band_tile<DHP>(q0, T, a.window, a.scale_log2, row, row, row, o);
    const int r0 = q0 + g, r1 = r0 + 8;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      const int col = 8 * d + 2 * t;
      if (r0 < T) *reinterpret_cast<float2*>(os + r0 * LD + col) = make_float2(o[d][0], o[d][1]);
      if (r1 < T) *reinterpret_cast<float2*>(os + r1 * LD + col) = make_float2(o[d][2], o[d][3]);
    }
  }
  __syncthreads();

  // the second rotary pass, positions 0 .. T: the token at 0, then a[i] at
  // i + 1
  float* outb = a.out + (size_t)b * (T + 1) * D + h * dh;
  const float* cb = a.coa + (size_t)b * D + h * dh;
  if (vec) {
    const int h4 = half / 4;
    for (int f = threadIdx.x; f < (T + 1) * h4; f += nthreads) {
      const int pos = f / h4, k = (f - pos * h4) * 4;
      const float* src = pos == 0 ? cb : os + (pos - 1) * LD;
      float4 y1, y2;
      rope4(ld4(src + k), ld4(src + k + half), ld4(cos_t + pos * half + k),
            ld4(sin_t + pos * half + k), y1, y2);
      *reinterpret_cast<float4*>(outb + (size_t)pos * D + k) = y1;
      *reinterpret_cast<float4*>(outb + (size_t)pos * D + k + half) = y2;
    }
  } else {
    for (int f = threadIdx.x; f < (T + 1) * half; f += nthreads) {
      const int pos = f / half, k = f - pos * half;
      const float* src = pos == 0 ? cb : os + (pos - 1) * LD;
      rope_pair(src[k], src[k + half], cos_t[pos * half + k], sin_t[pos * half + k],
                outb[(size_t)pos * D + k], outb[(size_t)pos * D + k + half]);
    }
  }
}

template <int DHP>
cudaError_t local_block_launch(const LocalArgs& a, int B, cudaStream_t s) {
  const size_t smem = (2 * (size_t)a.T + 8) * (DHP + 4) * sizeof(float);
  const cudaError_t e = set_smem(local_block_kernel<DHP>, smem);
  if (e != cudaSuccess) return e;
  const int nwarps = std::min(kMaxLocalWarps<DHP>, (a.T + 15) / 16);
  local_block_kernel<DHP><<<B * a.H, 32 * nwarps, smem, s>>>(a);
  return cudaSuccess;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The wide path's first rotary pass: r[b, i, h*dh + k] and [.. + dh / 2] =
// rope of x at position i, a thread a pair.
__global__ void rope_in_kernel(const float* __restrict__ x, const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t, float* __restrict__ r, int B,
                               int T, int D, int H) {
  const int half = D / H / 2;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * T * H * half) return;
  const int k = e % half, h = (e / half) % H, i = (e / half / H) % T;
  const long long off = e / half / H * D + h * 2 * half + k;  // (b*T + i)*D + h*dh + k
  rope_pair(x[off], x[off + half], cos_t[i * half + k], sin_t[i * half + k], r[off],
            r[off + half]);
}

// The wide path's second pass: out[b, 0] = rope(coa[b], 0), out[b, i + 1] =
// rope(a[b, i], i + 1), a thread a pair.
__global__ void rope_out_kernel(const float* __restrict__ a, const float* __restrict__ coa,
                                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                float* __restrict__ out, int B, int T, int D, int H) {
  const int half = D / H / 2;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * (T + 1) * H * half) return;
  const int k = e % half, h = (e / half) % H, pos = (e / half / H) % (T + 1);
  const long long b = e / half / H / (T + 1), col = h * 2 * half + k;
  const float* src = pos == 0 ? coa + b * D + col : a + (b * T + pos - 1) * D + col;
  float* dst = out + (b * (T + 1) + pos) * D + col;
  rope_pair(src[0], src[half], cos_t[pos * half + k], sin_t[pos * half + k], dst[0],
            dst[half]);
}

// whether a head's rows fit the one-block kernel's shared memory
bool fits_block(int T, int dh) {
  return dh <= kMaxPaddedWidth &&
         (2 * (size_t)T + 8) * ((dh + 15) / 16 * 16 + 4) * sizeof(float) <= kMaxSmem;
}

// whether a head that does not fit the one-block kernel runs in one launch
// of local_block_wide_kernel (its rows over the whole width in one block)
bool wide_in_one_launch(int dh) { return dh <= 272; }

// The local block at a head that does not fit the one-block kernel, up to
// 272 columns: local_block_wide_kernel, a warpgroup's half of the padded
// width 72, 128 or 136 wide
cudaError_t local_wide_launch(const LocalArgs& la, float scale, int B, cudaStream_t s) {
  const int dh = la.D / la.H;
  const AttnStrides rows{(long long)la.T * la.D, dh, la.D};
  WideFwdArgs a = wide_args(la.x, la.x, la.x, la.out, rows, rows, rows,
                            AttnStrides{(long long)(la.T + 1) * la.D, dh, la.D}, la.H, la.T, dh,
                            la.vec, scale);
  a.window = la.window;
  a.kv_same = a.qkv_same = true;
  a.coa = la.coa;
  a.cos_t = la.cos_t;
  a.sin_t = la.sin_t;
  if (dh <= 144)
    return wide_fwd_launch<9, 1, kBandKeys, true>(local_block_wide_kernel<9>, a, B, s);
  if (dh <= 256)
    return wide_fwd_launch<16, 1, kBandKeys, true>(local_block_wide_kernel<16>, a, B, s);
  return wide_fwd_launch<17, 1, kBandKeys, true>(local_block_wide_kernel<17>, a, B, s);
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Float32 elements of the workspace the block needs: 0 where a head fits
// the one-block kernel or runs in one launch of the wide kernel, else the
// rotated rows and the attention [B, T, D] of the three launches.
size_t gdt_local_block_workspace(int B, int T, int D, int H) {
  return fits_block(T, D / H) || wide_in_one_launch(D / H) ? 0 : 2 * (size_t)B * T * D;
}

// x [B, T, D] and coa [B, D] contiguous, cos_t and sin_t [T + 1, dh / 2]
// (dh = D / H even) -> out [B, T + 1, D]; ws as gdt_local_block_workspace
// asks.  Returns cudaGetLastError() after queueing the block on `stream`.
int gdt_local_block_f32(const float* x, const float* coa, const float* cos_t,
                        const float* sin_t, float* out, float* ws, int B, int T, int D, int H,
                        int window, float scale, void* stream) {
  const int dh = D / H;
  if (T < 1 || D % H || dh % 2 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = dh % 8 == 0 && D % 4 == 0 && aligned(x) && aligned(coa) && aligned(cos_t) &&
                   aligned(sin_t) && aligned(out);
  const LocalArgs a{x, coa, cos_t, sin_t, out, T, D, H, window, scale * 1.4426950408889634f, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fits_block(T, dh) && wide_in_one_launch(dh)) {
    const cudaError_t e = local_wide_launch(a, scale, B, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  if (!fits_block(T, dh)) {
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    float *r = ws, *att = ws + (size_t)B * T * D;
    const long long pairs_in = (long long)B * T * H * (dh / 2);
    const long long pairs_out = (long long)B * (T + 1) * H * (dh / 2);
    rope_in_kernel<<<(pairs_in + 255) / 256, 256, 0, s>>>(x, cos_t, sin_t, r, B, T, D, H);
    const AttnStrides rows{(long long)T * D, dh, D};
    const bool wvec = dh % 4 == 0 && D % 4 == 0 && aligned(ws);
    const cudaError_t e = band_wide_launch(r, r, r, att, rows, rows, rows, rows, B, H, T, dh,
                                           window, wvec, scale, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    rope_out_kernel<<<(pairs_out + 255) / 256, 256, 0, s>>>(att, coa, cos_t, sin_t, out, B, T,
                                                            D, H);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e = with_padded_width(
      dh, [&](auto w) { return local_block_launch<decltype(w)::value>(a, B, s); });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
