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
// (w 10) the band is ~1.6 GFLOP against ~0.2 GB of compulsory traffic when
// q = k = v, as in the local block (the input read once, the output written
// once): bound by memory bandwidth, ~0.060 ms at 3.35 TB/s.  The tensor
// cores do the padded work (16 queries against 40 keys a tile, ~4.0 GFLOP
// f32-equivalent), ~0.037 ms at mma.sync's measured ~108 TFLOP/s 3xTF32
// ceiling (tools/tf32_ceiling.py): under the byte bound.
//
// Design: the TPU kernel took a query block of BQ rows (a multiple of w)
// with its own and the previous aligned KV block and masked a [BQ, 2 BQ]
// score tile on the MXU.  Here the call's tiles of 64 queries, (batch,
// head) rows one after another, are cut into equal runs of consecutive
// tiles, one run a block and as many blocks as the card holds at once (a
// persistent grid, one wave, no tail); a block of 4 warps walks its run, a
// warp a 16-query tile through band_tile.cuh (3xTF32 mma.sync, the mask in
// registers, P in registers).  Tiles land in a shared-memory ring of slots
// through cp.async, two tiles ahead of the compute, so the previous
// window's rows are still resident when a tile needs them and every input
// row is read from device memory once, but for the band rows before a
// run's first tile (the traffic the bound counts).  When k or v alias q
// (the same pointer and strides, as on the model's path), their rows are
// staged once and read from q's ring.  Rows of a head width that is not a
// multiple of 16 are staged with zero columns up to DHP, 16 bytes a copy
// when every row is 16-byte aligned (dh % 4 == 0) and one float a copy
// otherwise; output columns past dh are never stored.  Heads wider than 128,
// and rings that would not fit a block's shared memory (three separate
// operands at DHP 128, or windows past ~50 frames), take wide_attention.cuh's
// band_wide_kernel: 64 queries a block over the whole width, the band's key
// tiles landed and split once, the scores once (its 128-column sliced
// kernel past 544).

#include "band_tile.cuh"
#include "wide_attention.cuh"

namespace {

constexpr int kBandWarps = 4;
constexpr int kBandThreads = 32 * kBandWarps;
constexpr int kBandBQ = 16 * kBandWarps;  // queries a tile
constexpr int kAhead = 2;                 // tiles in flight ahead of the compute
static_assert(kBandBQ == 64, "slot rows are j >> 6, j & 63");

struct Operand {
  const float* p;
  AttnStrides s;
};

struct BandArgs {
  Operand src[3];     // the distinct operands in ring order: q, then k, v unless aliased
  int nsrc;           // rings staged (1 when q = k = v)
  int kring, vring;   // the ring k and v are read from
  float* out;
  AttnStrides so;
  int H, T, dh, window;
  bool vec;           // 16-byte copies and float2 stores
  float scale_log2;   // dh^-0.5 * log2(e)
  int ring_tiles;     // tiles a ring holds, a power of two
  int ntiles;         // tiles of a (batch, head) row: ceil(T / 64)
  int total;          // tiles of the call: B * H * ntiles
  int per_block;      // consecutive tiles a block walks
};

// grid ceil(total / per_block); block kBandThreads.  Tile u is tile
// u % ntiles of (batch, head) row u / ntiles; it lands in ring slot u mod
// ring_tiles.
template <int DHP>
__global__ void __launch_bounds__(kBandThreads) band_attention_kernel(BandArgs a) {
  constexpr int LD = DHP + 4;  // see band_tile.cuh: conflict-free fragment reads
  constexpr int NO = DHP / 8, C4 = DHP / 4;
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, dh = a.dh, ntiles = a.ntiles, smask = a.ring_tiles - 1;
  const int ring_floats = a.ring_tiles * kBandBQ * LD;
  const int first = blockIdx.x * a.per_block, last = min(first + a.per_block, a.total);
  if (first >= last) return;

  // rows that are never staged read as zeros (band_tile.cuh reads up to 7
  // rows past a band)
  for (int f = threadIdx.x; f < a.nsrc * ring_floats; f += kBandThreads) smem[f] = 0.0f;
  __syncthreads();

  // rows [from, end) of tile u into slot u of every ring; rows past T and
  // columns past dh are zeros
  auto load_tile = [&](int u, int from) {
    const int bh = u / ntiles, b = bh / a.H, h = bh % a.H;
    const int r0 = max(from, (u % ntiles) * kBandBQ), r1 = (u % ntiles + 1) * kBandBQ;
    for (int r = 0; r < a.nsrc; ++r) {
      float* dst = smem + r * ring_floats + ((u & smask) * kBandBQ + r0 % kBandBQ) * LD;
      const float* src = a.src[r].p + b * a.src[r].s.b + h * a.src[r].s.h;
      const long long st = a.src[r].s.t;
      if (a.vec) {
        for (int f = threadIdx.x; f < (r1 - r0) * C4; f += kBandThreads) {
          const int i = f / C4, c = (f % C4) * 4, row = r0 + i;
          const bool in = row < T && c < dh;
          cp_async16(dst + i * LD + c, in ? src + row * st + c : src, in);
        }
      } else {
        copy_rows_scalar<DHP, LD>(dst, src, st, r0, r1 - r0, T, dh);
      }
    }
  };
  // the first tile with the band rows before it, then the tiles ahead
  const int tile0 = first % ntiles, from = band_lo(tile0 * kBandBQ, a.window);
  for (int tile = from / kBandBQ; tile <= tile0; ++tile) load_tile(first - tile0 + tile, from);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kAhead; ++i) {
    if (first + i < last) load_tile(first + i, 0);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int u = first; u < last; ++u) {
    cp_async_wait<kAhead - 1>();  // tile u has landed
    __syncthreads();              // ... for every thread; tile u - 1 is done
    if (u + kAhead < last) load_tile(u + kAhead, 0);
    cp_async_commit();
    const int bh = u / ntiles, b = bh / a.H, h = bh % a.H, u_row = u - u % ntiles;
    const int q0 = (u % ntiles) * kBandBQ + 16 * warp;
    if (q0 >= T) continue;
    // row j of this (batch, head) row: tile j / 64 of the row, slot mod ring
    auto slot = [&](int ring, int j) {
      return smem + ring * ring_floats +
             ((((u_row + (j >> 6)) & smask) << 6) + (j & (kBandBQ - 1))) * LD;
    };
    auto qrow = [&](int i) { return slot(0, i); };
    auto krow = [&](int j) { return slot(a.kring, j); };
    auto vrow = [&](int j) { return slot(a.vring, j); };
    float o[NO][4];
    band_tile<DHP>(q0, T, a.window, a.scale_log2, qrow, krow, vrow, o);
    float* ob = a.out + b * a.so.b + h * a.so.h;
    const int r0 = q0 + g, r1 = r0 + 8;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      const int col = 8 * d + 2 * t;
      store_pair(ob + r0 * a.so.t + col, o[d][0], o[d][1], r0 < T, col, dh, a.vec);
      store_pair(ob + r1 * a.so.t + col, o[d][2], o[d][3], r1 < T, col, dh, a.vec);
    }
  }
}

bool same(const Operand& x, const Operand& y) {
  return x.p == y.p && x.s.b == y.s.b && x.s.h == y.s.h && x.s.t == y.s.t;
}

template <int DHP>
cudaError_t band_launch(const BandArgs& a, cudaStream_t s) {
  const size_t smem = (size_t)a.nsrc * a.ring_tiles * kBandBQ * (DHP + 4) * sizeof(float);
  // one wave: as many blocks as fit on the card at once, each walking an
  // equal run of consecutive tiles
  int slots = 0;
  const cudaError_t e = wave_blocks(band_attention_kernel<DHP>, kBandThreads, smem, slots);
  if (e != cudaSuccess) return e;
  BandArgs args = a;
  args.per_block = (a.total + slots - 1) / slots;
  const int grid = (a.total + args.per_block - 1) / args.per_block;
  band_attention_kernel<DHP><<<grid, kBandThreads, smem, s>>>(args);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* gdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out [B, H, T, dh] through their strides (in floats, head width
// contiguous), any head width, window >= 1.  Returns
// cudaGetLastError() after queueing on `stream`.
int gdt_band_attention_f32(const float* q, const float* k, const float* v, float* out,
                           long long qb, long long qh, long long qt, long long kb,
                           long long kh, long long kt, long long vb, long long vh,
                           long long vt, long long ob, long long oh, long long ot,
                           int B, int H, int T, int dh, int window, float scale,
                           void* stream) {
  if (window < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Operand oq{q, {qb, qh, qt}}, ok{k, {kb, kh, kt}}, ov{v, {vb, vh, vt}};
  BandArgs a{};
  a.src[0] = oq;
  a.nsrc = 1;
  if (same(ok, oq)) {
    a.kring = 0;
  } else {
    a.kring = a.nsrc;
    a.src[a.nsrc++] = ok;
  }
  if (same(ov, oq)) {
    a.vring = 0;
  } else if (same(ov, ok)) {
    a.vring = a.kring;
  } else {
    a.vring = a.nsrc;
    a.src[a.nsrc++] = ov;
  }
  a.out = out;
  a.so = AttnStrides{ob, oh, ot};
  a.H = H;
  a.T = T;
  a.dh = dh;
  a.window = window;
  a.vec = dh % 4 == 0 && aligned16(q, oq.s) && aligned16(k, ok.s) && aligned16(v, ov.s) &&
          aligned16(out, a.so);
  a.scale_log2 = scale * 1.4426950408889634f;
  a.ntiles = (T + kBandBQ - 1) / kBandBQ;
  a.total = B * H * a.ntiles;
  // the band of a tile reaches 2w - 1 rows back, into earlier tiles; the
  // tile and kAhead tiles ahead of it are resident too
  const int tiles = (2 * window - 1 + kBandBQ - 1) / kBandBQ + 1 + kAhead;
  a.ring_tiles = 1;
  while (a.ring_tiles < tiles) a.ring_tiles *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t ring_bytes = (size_t)a.nsrc * a.ring_tiles * kBandBQ *
                            ((dh + 15) / 16 * 16 + 4) * sizeof(float);
  const cudaError_t e =
      dh > kMaxPaddedWidth || ring_bytes > kMaxSmem
          ? band_wide_launch(q, k, v, out, oq.s, ok.s, ov.s, a.so, B, H, T, dh, window, a.vec,
                             scale, s)
          : with_padded_width(dh,
                              [&](auto w) { return band_launch<decltype(w)::value>(a, s); });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
