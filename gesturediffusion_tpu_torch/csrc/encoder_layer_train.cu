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
// arithmetic (f32 SIMT, no tensor cores: ~0.13 and ~0.38 ms at 67 TFLOP/s).
//
// Design: the TPU kernels kept a batch block in VMEM and accumulated the
// weight gradients in VMEM scratch across a sequential grid.  Here each
// entry point is a chain of launches on one stream:
//   * the SIMT GEMM of common.cuh (shared with the inference layer,
//     csrc/encoder_layer.cu), which reads either operand along K or along
//     its other axis, so the forward products (A . W^T), the data gradients
//     (dY . W) and the weight gradients (dY^T . X, a reduction over all B*T
//     rows) share it.  The weight gradients split the row reduction into
//     chunks that fill the card and add the partial sums in a second pass,
//     in a fixed order: deterministic, no atomics.  Fused epilogues apply
//     bias, GELU-tanh, dropout, the GELU derivative and residuals;
//   * the attention forward of common.cuh (a block per (batch, head), a
//     warp per two query rows) with its site-0 dropout, and here its
//     backward, which keeps Q, K, V, dO and the [T, T] probability
//     gradients of its head in shared memory;
//   * LayerNorm forward (common.cuh) and backward row kernels (a warp per
//     row) and a column-sum kernel for the bias and LayerNorm-parameter
//     gradients.
// The backward's recomputed intermediates live in one workspace that the
// caller allocates for the call and frees after it; nothing but x, the
// weights and the seed is kept between forward and backward.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kColX = 32, kColY = 16;  // column-sum block: 32 columns
constexpr int kTargetBlocks = 264;     // two GEMM blocks per H100 SM
constexpr int kSumThreads = 256;

// Attention backward of one (batch, head): qkv [B*T, 3D] and dout [B*T, D]
// -> dqkv [B*T, 3D].  The softmax is recomputed from q and k and the site-0
// masks redrawn.  With p the undropped probabilities and pd the dropped:
//   dv = pd^T dO;  dp = keep ? (dO v^T) / keep : 0;
//   ds = p * (dp - rowsum(dp * p)) * scale;  dq = ds k;  dk = ds^T q.
// Q, K, V, dO ([T][dh + 4]) and ds, pd ([T][tp]) stay in shared memory.
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                float* __restrict__ dqkv, int T, int D, int H, float scale,
                Drop drop) {
  extern __shared__ __align__(16) float smem[];
  const int dh = D / H, ks = dh + 4, tp = (T + 3) & ~3;
  const int nwarps = blockDim.x >> 5;
  float* Qs = smem;
  float* Ks = Qs + T * ks;
  float* Vs = Ks + T * ks;
  float* Os = Vs + T * ks;   // dO
  float* dS = Os + T * ks;   // [T][tp]
  float* Pd = dS + T * tp;   // [T][tp]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* base = qkv + (size_t)b * T * 3 * D + h * dh;
  const float* obase = dout + (size_t)b * T * D + h * dh;

  const int dh4 = dh / 4;
  for (int idx = threadIdx.x; idx < T * dh4; idx += blockDim.x) {
    const int j = idx / dh4, d = (idx - j * dh4) * 4;
    const float* row = base + (size_t)j * 3 * D + d;
    *reinterpret_cast<float4*>(Qs + j * ks + d) = ld4(row);
    *reinterpret_cast<float4*>(Ks + j * ks + d) = ld4(row + D);
    *reinterpret_cast<float4*>(Vs + j * ks + d) = ld4(row + 2 * D);
    *reinterpret_cast<float4*>(Os + j * ks + d) = ld4(obase + (size_t)j * D + d);
  }
  __syncthreads();

  const bool has_drop = drop.seed != nullptr;
  const uint32_t salt = has_drop ? site_salt(drop.seed, kSiteAttn) : 0u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < T; i += nwarps) {
    const float* qi = Qs + i * ks;
    const float* oi = Os + i * ks;
    float* ds = dS + i * tp;
    float* pd = Pd + i * tp;
    float m = -FLT_MAX;
    for (int j = lane; j < T; j += 32) {
      const float* kj = Ks + j * ks;
      float s = 0.0f;
      for (int d = 0; d < dh; d += 4) {
        const float4 k4 = ld4(kj + d), a = ld4(qi + d);
        s = fmaf(a.x, k4.x, s); s = fmaf(a.y, k4.y, s);
        s = fmaf(a.z, k4.z, s); s = fmaf(a.w, k4.w, s);
      }
      s *= scale;
      ds[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(ds[j] - m);
      ds[j] = e;
      l += e;
    }
    l = warp_sum(l);
    const uint32_t row_idx = (static_cast<uint32_t>(b * H + h) * T + i) * T;
    float r = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float* vj = Vs + j * ks;
      float dpd = 0.0f;
      for (int d = 0; d < dh; d += 4) {
        const float4 v4 = ld4(vj + d), a = ld4(oi + d);
        dpd = fmaf(a.x, v4.x, dpd); dpd = fmaf(a.y, v4.y, dpd);
        dpd = fmaf(a.z, v4.z, dpd); dpd = fmaf(a.w, v4.w, dpd);
      }
      const float p = ds[j] / l;
      const float dp = has_drop ? dropped(dpd, row_idx + j, salt, drop) : dpd;
      ds[j] = p;
      pd[j] = dp;  // dp until the row sum is known
      r = fmaf(dp, p, r);
    }
    r = warp_sum(r);
    for (int j = lane; j < T; j += 32) {
      const float p = ds[j], dp = pd[j];
      ds[j] = p * (dp - r) * scale;
      pd[j] = has_drop ? dropped(p, row_idx + j, salt, drop) : p;
    }
  }
  __syncthreads();

  // dq[i] = sum_j ds[i][j] k[j]; dk[j] = sum_i ds[i][j] q[i];
  // dv[j] = sum_i pd[i][j] dO[i].  A warp shares the row and spans d, so the
  // [T][tp] reads broadcast and the [T][dh + 4] reads are consecutive.
  for (int e = threadIdx.x; e < T * dh; e += blockDim.x) {
    const int i = e / dh, d = e - i * dh;
    float dq = 0.0f, dk = 0.0f, dv = 0.0f;
    for (int j = 0; j < T; ++j) {
      dq = fmaf(dS[i * tp + j], Ks[j * ks + d], dq);
      dk = fmaf(dS[j * tp + i], Qs[j * ks + d], dk);
      dv = fmaf(Pd[j * tp + i], Os[j * ks + d], dv);
    }
    float* row = dqkv + ((size_t)b * T + i) * 3 * D + h * dh + d;
    row[0] = dq;
    row[D] = dk;
    row[2 * D] = dv;
  }
}

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
  for (int d = lane; d < D; d += 32) {
    const float xhat = (x[d] - mu) * rs;
    const float dx = rs * (g[d] * w[d] - mean_gy - xhat * mean_gyx);
    dX[off + d] = dx;
    dXd[off + d] = has_drop ? dropped(dx, static_cast<uint32_t>(off + d), salt, drop) : dx;
    P[off + d] = g[d] * xhat;
  }
}

// out[c] = sum_r X[r, c] for X [M, N]: a block of 32 x 16 threads per 32
// columns, rows summed in a fixed order.
__global__ void __launch_bounds__(kColX * kColY)
colsum_kernel(const float* __restrict__ X, float* __restrict__ out, int M, int N) {
  __shared__ float part[kColY][kColX + 1];
  const int tx = threadIdx.x & (kColX - 1), ty = threadIdx.x / kColX;
  const int c = blockIdx.x * kColX + tx;
  float s = 0.0f;
  if (c < N)
    for (int r = ty; r < M; r += kColY) s += X[(size_t)r * N + c];
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

// C[I, J] = epi(A[I, K] . W[K, J]): the data gradients (W in [out, in])
template <int EPI>
void gemm_nn(const float* A, const float* W, float* C, int I, int J, int K,
             const EpiArgs& ep, cudaStream_t s) {
  gemm<true, false, EPI>(A, W, C, I, J, K, K, J, 1, K, ep, s);
}

// How many row chunks a weight gradient [I, J] over M rows is split into,
// and the chunk length (a multiple of kBK): enough blocks to fill the card.
int weight_grad_splits(int I, int J, int M, int* chunk) {
  const int tiles = ((I + kBM - 1) / kBM) * ((J + kBN - 1) / kBN);
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, M / 128));
  int c = (M + splits - 1) / splits;
  c = (c + kBK - 1) / kBK * kBK;
  *chunk = c;
  return (M + c - 1) / c;
}

// dW[I, J] = sum_m dY[m, i] X[m, j] (dY [M, I], X [M, J]); `part` holds the
// split partial sums.
void weight_grad(const float* dY, const float* X, float* dW, float* part,
                 int M, int I, int J, cudaStream_t s) {
  int chunk;
  const int splits = weight_grad_splits(I, J, M, &chunk);
  const EpiArgs ep{};
  if (splits == 1) {
    gemm<false, false, kPlain>(dY, X, dW, I, J, M, I, J, 1, chunk, ep, s);
    return;
  }
  gemm<false, false, kPlain>(dY, X, part, I, J, M, I, J, splits, chunk, ep, s);
  const int n = I * J;
  sum_splits_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      part, dW, n, splits);
}

void colsum(const float* X, float* out, int M, int N, cudaStream_t s) {
  colsum_kernel<<<(N + kColX - 1) / kColX, kColX * kColY, 0, s>>>(X, out, M, N);
}

void ln_bwd(const float* X, const float* G, const float* w, float* dX,
            float* dXd, float* P, int M, int D, const Drop& drop, int site,
            cudaStream_t s) {
  const int rows_per_block = kLnThreads / 32;
  ln_bwd_kernel<<<(M + rows_per_block - 1) / rows_per_block, kLnThreads, 0, s>>>(
      X, G, w, dX, dXd, P, M, D, drop, site);
}

size_t attn_bwd_smem(const Dims& n) {
  const size_t dh = n.D / n.H, tp = (n.T + 3) & ~3;
  return (4 * (size_t)n.T * (dh + 4) + 2 * (size_t)n.T * tp) * sizeof(float);
}

// The forward chain.  qkv [M, 3D], o, u, y1, v2 [M, D], hd and (if not null)
// h1 [M, F] are written; the layer output goes to `out`.
struct Weights {
  const float *wqkv, *bqkv, *wo, *bo, *ln1_w, *ln1_b, *w1, *b1, *w2, *b2,
      *ln2_w, *ln2_b;
};

cudaError_t forward_chain(const float* x, const Weights& w, const Drop& drop,
                          const Dims& n, float scale, float* qkv, float* o,
                          float* u, float* y1, float* h1, float* hd, float* v2,
                          float* out, cudaStream_t s) {
  const int M = n.M, D = n.D, F = n.F;
  EpiArgs ep{};
  ep.bias = w.bqkv;
  gemm_nt<kBias>(x, w.wqkv, qkv, M, 3 * D, D, ep, s);
  const cudaError_t e = attention(qkv, o, n.B, n.T, D, n.H, scale, drop, s);
  if (e != cudaSuccess) return e;
  ep = EpiArgs{w.bo, x, nullptr, nullptr, drop, kSitePostAttn};
  gemm_nt<kBiasResid>(o, w.wo, u, M, D, D, ep, s);
  layernorm(u, w.ln1_w, w.ln1_b, y1, M, D, s);
  ep = EpiArgs{w.b1, nullptr, nullptr, h1, drop, kSiteAct};
  gemm_nt<kBiasGelu>(y1, w.w1, hd, M, F, D, ep, s);
  ep = EpiArgs{w.b2, y1, nullptr, nullptr, drop, kSiteFF};
  gemm_nt<kBiasResid>(hd, w.w2, v2, M, D, F, ep, s);
  layernorm(v2, w.ln2_w, w.ln2_b, out, M, D, s);
  return cudaSuccess;
}

Drop make_drop(const int* seed, unsigned thresh, float inv_keep, int use_dropout) {
  return Drop{use_dropout ? seed : nullptr, thresh, inv_keep};
}

size_t split_floats(const Dims& n) {
  size_t most = 0;
  const int shapes[4][2] = {{3 * n.D, n.D}, {n.D, n.D}, {n.F, n.D}, {n.D, n.F}};
  for (const auto& ij : shapes) {
    int chunk;
    const int splits = weight_grad_splits(ij[0], ij[1], n.M, &chunk);
    if (splits > 1) most = std::max(most, (size_t)splits * ij[0] * ij[1]);
  }
  return most;
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
  return M * (18 * (size_t)D + 2 * (size_t)F) + split_floats(n);
}

// Forward: x [B, T, D] -> out [B, T, D].  `seed` points at one int32 on the
// device; thresh and inv_keep come from the caller (rate 0: use_dropout 0).
// Returns cudaGetLastError() after queueing the chain on `stream`.
int gdt_encoder_layer_train_fwd_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, const int* seed, float* out, float* ws, int B, int T,
    int D, int F, int H, float scale, unsigned thresh, float inv_keep,
    int use_dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims n{B, T, D, F, H, B * T};
  const Weights w{wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  const size_t M = n.M;
  float* qkv = ws;
  float* o = qkv + M * 3 * D;
  float* u = o + M * D;
  float* y1 = u + M * D;
  float* v2 = y1 + M * D;
  float* hd = v2 + M * D;
  const cudaError_t e = forward_chain(x, w, make_drop(seed, thresh, inv_keep, use_dropout),
                                      n, scale, qkv, o, u, y1, nullptr, hd, v2, out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Backward: recompute the forward from x, then from g = dL/dout produce dx
// and the 12 gradients (each in its parameter's layout).
int gdt_encoder_layer_train_bwd_f32(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* ln1_w, const float* ln1_b, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* ln2_w,
    const float* ln2_b, const int* seed, const float* g, float* dx,
    float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* dln1_w,
    float* dln1_b, float* dw1, float* db1, float* dw2, float* db2,
    float* dln2_w, float* dln2_b, float* ws, int B, int T, int D, int F, int H,
    float scale, unsigned thresh, float inv_keep, int use_dropout,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims n{B, T, D, F, H, B * T};
  const Weights w{wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b};
  const Drop drop = make_drop(seed, thresh, inv_keep, use_dropout);
  const size_t M = n.M;
  float* qkv = ws;
  float* dqkv = qkv + M * 3 * D;
  float* h1 = dqkv + M * 3 * D;
  float* hd = h1 + M * F;      // then dh1
  float* o = hd + M * F;
  float* u = o + M * D;
  float* y1 = u + M * D;
  float* v2 = y1 + M * D;
  float* dv = v2 + M * D;
  float* dff = dv + M * D;
  float* P = dff + M * D;
  float* dy1 = P + M * D;
  float* du = dy1 + M * D;
  float* da = du + M * D;
  float* dout = da + M * D;
  float* y2 = dout + M * D;    // the recomputed output, unused
  float* part = y2 + M * D;

  const size_t smem = attn_bwd_smem(n);
  cudaError_t e = set_smem(attn_bwd_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = forward_chain(x, w, drop, n, scale, qkv, o, u, y1, h1, hd, v2, y2, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  const int Mi = n.M;
  EpiArgs ep{};
  // LN2 and the feed-forward branch
  ln_bwd(v2, g, ln2_w, dv, dff, P, Mi, D, drop, kSiteFF, s);
  colsum(P, dln2_w, Mi, D, s);
  colsum(g, dln2_b, Mi, D, s);
  weight_grad(dff, hd, dw2, part, Mi, D, F, s);
  colsum(dff, db2, Mi, D, s);
  ep = EpiArgs{nullptr, nullptr, h1, nullptr, drop, kSiteAct};
  gemm_nn<kDropGeluGrad>(dff, w2, hd, Mi, F, D, ep, s);  // hd <- dh1
  weight_grad(hd, y1, dw1, part, Mi, F, D, s);
  colsum(hd, db1, Mi, F, s);
  ep = EpiArgs{nullptr, dv, nullptr, nullptr, Drop{}, 0};
  gemm_nn<kResid>(hd, w1, dy1, Mi, D, F, ep, s);
  // LN1 and the attention branch
  ln_bwd(u, dy1, ln1_w, du, da, P, Mi, D, drop, kSitePostAttn, s);
  colsum(P, dln1_w, Mi, D, s);
  colsum(dy1, dln1_b, Mi, D, s);
  weight_grad(da, o, dwo, part, Mi, D, D, s);
  colsum(da, dbo, Mi, D, s);
  gemm_nn<kPlain>(da, wo, dout, Mi, D, D, EpiArgs{}, s);
  attn_bwd_kernel<<<n.B * n.H, kAttnThreads, smem, s>>>(qkv, dout, dqkv, n.T, D,
                                                        n.H, scale, drop);
  weight_grad(dqkv, x, dwqkv, part, Mi, 3 * D, D, s);
  colsum(dqkv, dbqkv, Mi, 3 * D, s);
  ep = EpiArgs{nullptr, du, nullptr, nullptr, Drop{}, 0};
  gemm_nn<kResid>(dqkv, wqkv, dx, Mi, D, 3 * D, ep, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
