#!/usr/bin/env python3
"""The shipped 3xTF32 kernels against patched copies of themselves, on one card.

    python3 tools/kernel_variants.py [prefix ...]

Each variant (or only those whose names start with a prefix given) is a copy of gesturediffusion_tpu_torch/csrc/ under
build/variants/<name>/ with a few source lines replaced (VARIANTS below),
built with the port's nvcc flags; its C entry points are called through
ctypes, in turns with the shipped build, on the same inputs (the band and
local-block kernels timed by the profiler's device time, as chip_smoke.py
does):

  cvt_rounding       TF32 rounding by cvt.rna.tf32.f32 instead of the two
                     integer operations of tf32_rn (the same rounding)
  band_no_math       the band kernel without its band tiles (the ring's
                     loads, barriers and the stores of zeros are left)
  band_no_loads      the band kernel without its ring loads (the tiles
                     compute on stale shared memory)
  band_5_blocks      the band kernel with registers capped for 5 (6) blocks
  band_6_blocks      an SM (__launch_bounds__'s second argument)
  band_q_split_once  the band tile splitting Q's fragments once, held in
  local_q_split_once registers for the tile, instead of as it uses them
  band_pv_two_acc    P V summed into two accumulators (even and odd key
                     tiles), half the dependent chain of mma.sync
  band_rz_split      the split without rounding: the raw f32 bits as the big
  local_rz_split     part and x - (x truncated to TF32) as the small one
                     (the tensor cores read a TF32 operand's top 19 bits);
                     their errors are checked
  local_uncapped     the local block in blocks of up to 16 warps, registers
                     not capped, at every padded width (shipped above DHP
                     32; at DHP 32 3 blocks an SM at T 80)
  local_5_blocks     the local block's registers capped for 5 blocks an SM
                     at DHP 32 (shipped: 4)
  local_cap_all      blocks of up to 5 warps capped for 4 blocks an SM at
                     every padded width (shipped at DHP 32 only)
  local_no_attention the local block without its band tiles (the rotary
                     passes, loads and stores are left)
  local_rows         the local block in whole rows,
                     tools/variants/local_block_rows.cu in place of
                     csrc/local_block.cu: a one-wave persistent grid over
                     (batch row, 16-query tile) units, whole 1 KB rows of x
                     copied by the TMA engine (cp.async.bulk on mbarriers)
                     into two slabs, the next unit's in flight
  local_rows_no_attention  local_rows without its band tiles
  local_rows_no_copies     local_rows without its bulk copies (the units
                     compute on stale shared memory)
  wide_sliced        the flash forward past a head width of 128 as first
                     written: flash_wide_launch sent to flash_sliced_launch
                     at every width (128-column slices, a block each, every
                     one recomputing the scores from fragments read from
                     device memory), in the flash, inference and training
                     libraries
  wide_bwd_sliced    the training layer's attention backward past a head
                     width of 128 as first written: attention_backward_wide
                     sent to the sliced passes at every width (in the
                     training library)
  band_sliced        the band and the local block past a head width of 128
                     as first written: band_wide_launch sent to
                     band_sliced_launch at every width (128-column slices,
                     a block each, every one recomputing the scores from
                     fragments read from device memory) and the local block
                     past a block's rows to its three launches (rope_in,
                     the band, rope_out, in a workspace), in the band and
                     local-block libraries
  wbwd_no_scores     the wide passes without their score products (the
                     scores read as zeros)
  wbwd_no_outputs    the wide passes without their output wgmmas (the
                     split score fragments folded into the accumulators)
  wbwd_no_split      the wide passes without splitting their streamed tiles
                     (the products read stale split tiles)
  wbwd_no_loads      the wide passes without loading their streamed tiles
                     after the first (the split reads stale rows)
  wbwd_bounded       the wide passes' score loop with its bound check at
                     every width (shipped: none where the half is KS steps)
  narrow_mma_sync    the flash forward up to a head width of 128 as PR 4
                     wrote it: the inference dispatch sent to the training
                     body (mma.sync.m16n8k8, 4 warps, K and V split as
                     each warp reads them), in the flash and inference
                     libraries
  narrow_bk32        the inference body with 32-key tiles at every shape
  narrow_bk64        ... with 64-key tiles up to DHP 64 at every length
                     (shipped: 64 there where T > 128, else 32)
  narrow_one_consumer the inference body with one consumer warpgroup (64
                     query rows a block) at every width (shipped: two up to
                     DHP 96)
  narrow_no_split    the inference body's producer without its split pass
                     (the products read stale split tiles)
  narrow_no_softmax  the inference body without its exponentials
  narrow_no_products the inference body without its wgmmas (the split
                     fragments folded into the accumulators)
  narrow_no_loads    the inference body without its tensor copies (the raw
                     tiles stay as they are)
  narrow_bare        all four removed: the pipeline's hand-offs, the q and
                     output passes and the softmax's other work are left
  ws_parent          kernel 1's products on the parent GEMM again
                     (gemm_tf32x3.cuh's gemm_nt, the LayerNorm row kernel
                     after the out-projection and ff2): layer_routes sends
                     every product there
  ws_no_loads        gemm_ws.cuh without its tensor copies (the ring keeps
                     stale data; the producer still signals each stage)
  ws_no_a_split      gemm_ws.cuh's consumers without reading and splitting A's
                     fragments (constant bits in their place)
  ws_no_ln           gemm_ws.cuh without the LayerNorm epilogue: the
                     out-projection and ff2 with the residual epilogue, the
                     row kernel after each (seven launches at D 256)
  ws_ln_one_consumer the LayerNorm route's 64 x 256 tiles on one consumer
                     warpgroup of n256 (shipped: two of 128 columns each,
                     the row sums exchanged in shared memory)
  ws_cols            the bias, GELU and residual routes on 64 x 256 tiles,
                     the two consumers 128 columns each, as the LayerNorm
                     route (shipped: 128 x 128, 64 rows each, or 64 x 128
                     where those fit one wave)
  ws_no_short        those routes on 128 x 128 tiles at every M (shipped:
                     64 x 128, 64 columns a consumer, where those fit one
                     wave of the card)
  train_parent       kernels 5 and 6's products on the parent GEMM again
                     (gemm_tf32x3.cuh): train_routes sends every product
                     there

The variants whose errors are not checked (*_no_* but ws_no_ln,
*_blocks, band_pv_two_acc, narrow_bare) are ablations, timed to see what a
phase or a choice costs.  One line a case: the encoder layer at [82, 81,
256] and [82, 1201, 256] (ff 1024, 4 heads; its products' device time from the
profiler at 1201 rows), the flash kernel at [82, 4, 1201, 64], the band
kernel at [82, 8, 1200, 32] (the local block's aliased, transposed heads),
the local block at [82, 80, 256] and [82, 80, 320] (heads of 40), and, for
wide_sliced, the flash kernel at [82, 4, 1201, 256] and [82, 4, 1201, 520],
the encoder layer at [82, 1201, 1024] (heads of 256, ff 1024) and the
training layer's forward and forward + backward at [64, 81, 1024] (heads of
256, ff 1024, rate 0.1) in the turns shipped, variant, variant, shipped
beside one F.scaled_dot_product_attention call (the training rows: the
layer around it, chip_smoke.py's encoder_layer_sdpa, forward and forward +
backward), with the card's name and power limit.  wide_bwd_sliced times
kernel 6 at [64, 81, 1024] and [64, 81, 2080] (heads of 256 and 520, ff
1024, rate 0.1) by CUDA events and its attention backward's passes inside
it by the profiler's device time, in the same turns, beside the SDPA
layer's forward + backward and SDPA's attention backward alone
(chip_smoke.py's sdpa_backward_ms); the wbwd_* variants (the wbwd_no_*
ablations unchecked) in the turns shipped, each variant, each again in
reverse order, shipped.  Given alone (no other variant
chosen) they build and time only the training library.  band_sliced times
the band kernel at [82, 8, 1200, 136] and [82, 8, 1200, 264] (q = k = v the
local block's transposed heads, window 10) and at [82, 8, 1200, 128]
window 60 (past the narrow ring's shared memory), and the local block at
[82, 80, 1088] and [82, 80, 2112] (8 heads of 136 and 264), by the
profiler's device time of a call (every kernel of it), in the turns
shipped, band_sliced, band_sliced, shipped, beside the plain twin and the
library (chip_smoke.py's band_sdpa and local_block_sdpa) by CUDA events;
given alone it builds and times only those two libraries.  The narrow_*
variants time the flash forward alone (by CUDA events and by the
profiler's device time) at [82, 4, 81, 64] (the gesture step), [82, 4,
1201, 64], [82, 4, 1201, 80], [6, 4, 197, 128], [64, 4, 197, 128] and [32,
4, 197, 128], and kernel 1 at [82, 81, 256], [6, 197, 512], [64, 197, 512],
[32, 197, 512], [64, 61, 512] and [12, 61, 512] (4 heads, ff 1024), in the
turns shipped, each variant, each again in reverse order, shipped, each
beside the plain twin, the library call (SDPA; the SDPA layer) and the
bound; given alone they build and time only the flash and inference
libraries.  The ws_* variants time kernel 1 at [82, 81, 256], [6, 197, 512],
[64, 197, 512], [32, 197, 512], [64, 61, 512] and [12, 61, 512] (4 heads,
ff 1024; CUDA events over back-to-back calls, and the profiler's device
time of its products: every gemm_ws_kernel and gemm_tf32x3_kernel of a
call) in the turns shipped, each variant, each again in reverse order,
shipped, then
the products row: each of the four products alone at the gesture layer's
[6642 rows, D 256] and the t2m layer's [12608, 512] (ff 1024) by the
profiler's device time a launch, on gemm_ws.cuh and on the parent GEMM
(csrc/encoder_layer.cu's gdt_gemm_ws_f32 and gdt_gemm_parent_f32, shipped
build), beside F.linear in full f32 (TF32 off; the profiler's device time
of its kernels) and the product's bound, 3 x FLOP / 495 TFLOP/s; given
alone they build and time only the inference library.  train_parent times
kernels 5 and 6 at [64, 81, 256], [64, 121, 256], [64, 197, 512] and [64,
61, 512] (4 heads, ff 1024, rate 0.1; CUDA events over back-to-back calls,
and the profiler's device time of their products) in the turns shipped,
train_parent, train_parent, shipped, each output checked bit for bit
against the first turn's; given alone it builds and times only the
training library.  A patch that no longer matches the sources fails loudly
(tests/test_torch_kernel_variants.py checks every patch on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

M = "mma_tf32x3.cuh"
BAND, LOCAL, TILE = "band_attention.cu", "local_block.cu", "band_tile.cuh"
WIDE, FLASH = "wide_attention.cuh", "flash_attention.cuh"
WIDE_DISPATCH = "  if (dh <= 144)\n    return flash_fwd_wide_launch<DROP, 9, 1>("
TRAIN = "encoder_layer_train.cu"
WIDE_BWD_DISPATCH = "  if (a.dh <= 144) return attn_bwd_wide_launch<DROP, 9, 1>(a, s);\n"
# keeps a split score fragment alive where an ablation drops its product
KEEP_A = " ^ ".join(f"a_{p}[{i}]" for p in ("big", "small") for i in range(4))
ZERO_O = "    for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;"
VARIANTS = {
    "cvt_rounding": [(M, "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                      "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
                      "  return r;")],
}
ROWS = (LOCAL, None, "local_block_rows.cu")  # the whole file, from tools/variants/
BAND_CALL = "    band_tile<DHP>(q0, T, a.window, a.scale_log2, qrow, krow, vrow, o);"
LOCAL_CALL = "    band_tile<DHP>(q0, T, a.window, a.scale_log2, row, row, row, o);"
ROWS_CALL = "      band_tile<DHP>(q0, T, w, a.scale_log2, row, row, row, o);"
Q_SPLIT_ONCE = [
    (TILE, "  float qf[KC][4];\n", "  float qf[KC][4];\n  uint32_t qbig[KC][4], qsmall[KC][4];\n"),
    (TILE, "      qf[c][3] = in_hi ? qh[8 * c + t + 4] : 0.0f;\n",
     "      qf[c][3] = in_hi ? qh[8 * c + t + 4] : 0.0f;\n#pragma unroll\n"
     "      for (int e = 0; e < 4; ++e) split_tf32(qf[c][e], qbig[c][e], qsmall[c][e]);\n"),
    (TILE, "        for (int e = 0; e < 4; ++e) split_tf32(qf[c][e], a_big[e], a_small[e]);",
     "        for (int e = 0; e < 4; ++e) {\n          a_big[e] = qbig[c][e];\n"
     "          a_small[e] = qsmall[c][e];\n        }")]
RZ_SPLIT = [(M, "  big = tf32_rn(x);\n  small = tf32_rn(x - __uint_as_float(big));",
             "  big = __float_as_uint(x);\n"
             "  small = __float_as_uint(x - __uint_as_float(big & 0xFFFFE000u));")]
LOCAL_BOUNDS = "__launch_bounds__(32 * kMaxLocalWarps<DHP>, DHP <= 32 ? 4 : 1)"
LOCAL_WARPS = "constexpr int kMaxLocalWarps = DHP <= 32 ? 5 : 16;"
VARIANTS.update({
    "band_no_math": [(BAND, BAND_CALL, ZERO_O)],
    "band_no_loads": [
        (BAND, "  for (int tile = from / kBandBQ; tile <= tile0; ++tile) load_tile(first - tile0 + tile, "
               "from);", ""),
        (BAND, "    if (first + i < last) load_tile(first + i, 0);", ""),
        (BAND, "    if (u + kAhead < last) load_tile(u + kAhead, 0);", "")],
    "band_5_blocks": [(BAND, "__global__ void __launch_bounds__(kBandThreads) band_attention_kernel",
                       "__global__ void __launch_bounds__(kBandThreads, 5) band_attention_kernel")],
    "band_6_blocks": [(BAND, "__global__ void __launch_bounds__(kBandThreads) band_attention_kernel",
                       "__global__ void __launch_bounds__(kBandThreads, 6) band_attention_kernel")],
    "band_q_split_once": Q_SPLIT_ONCE,
    "band_pv_two_acc": [
        (TILE, "    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;",
         "    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;\n  float o2[NO][4] = {};"),
        (TILE, "      o[d][3] *= al_hi;",
         "      o[d][3] *= al_hi;\n      o2[d][0] *= al_lo; o2[d][1] *= al_lo; o2[d][2] *= al_hi; "
         "o2[d][3] *= al_hi;"),
        (TILE, "        mma_tf32x3(o[d], p_big, p_small, b_big, b_small);",
         "        mma_tf32x3((n & 1) ? o2[d] : o[d], p_big, p_small, b_big, b_small);"),
        (TILE, "  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;",
         "  for (int d = 0; d < NO; ++d) for (int e = 0; e < 4; ++e) o[d][e] += o2[d][e];\n"
         "  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;")],
    "band_rz_split": RZ_SPLIT,
    "local_q_split_once": Q_SPLIT_ONCE,
    "local_uncapped": [(LOCAL, LOCAL_WARPS, "constexpr int kMaxLocalWarps = 16;"),
                       (LOCAL, LOCAL_BOUNDS, "__launch_bounds__(32 * kMaxLocalWarps<DHP>)")],
    "local_5_blocks": [(LOCAL, LOCAL_BOUNDS,
                        "__launch_bounds__(32 * kMaxLocalWarps<DHP>, DHP <= 32 ? 5 : 1)")],
    "local_cap_all": [(LOCAL, LOCAL_WARPS, "constexpr int kMaxLocalWarps = 5;"),
                      (LOCAL, LOCAL_BOUNDS, "__launch_bounds__(32 * kMaxLocalWarps<DHP>, 4)")],
    "local_no_attention": [(LOCAL, LOCAL_CALL, ZERO_O)],
    "local_rz_split": RZ_SPLIT,
    "local_rows": [ROWS],
    "local_rows_no_attention": [ROWS, (LOCAL, ROWS_CALL, "  " + ZERO_O)],
    "wide_sliced": [(WIDE, WIDE_DISPATCH,
                     "  return flash_sliced_launch<DROP>(q, k, v, out, sq, sk, sv, so, B, H, T, dh, "
                     "vec, scale, drop,\n                                   lse, s);\n"
                     + WIDE_DISPATCH)],
    "wide_bwd_sliced": [(TRAIN, WIDE_BWD_DISPATCH,
                         "  return attn_bwd_sliced_launch<DROP>(a, s);\n" + WIDE_BWD_DISPATCH)],
    "band_sliced": [(WIDE, "  if (dh > 544)\n    return band_sliced_launch<NT>(",
                     "  if (true)\n    return band_sliced_launch<NT>("),
                    (LOCAL, "bool wide_in_one_launch(int dh) { return dh <= 272; }",
                     "bool wide_in_one_launch(int dh) { return false; }")],
    "wbwd_no_scores": [(TRAIN, "    if (live) {\n      if (ks == KS)",
                        "    if (false) {\n      if (ks == KS)")],
    "wbwd_no_outputs": [
        (TRAIN, "      wide_out_x3<WO>(acc1, a_big, a_small, big1 + wg_off, small1 + wg_off);\n",
         "      acc1[0] += __uint_as_float(" + KEEP_A + ");\n"),
        (TRAIN, "      wide_out_x3<WO>(acc1, a_big, a_small, big2 + wg_off, small2 + wg_off);\n"
                "      wide_out_x3<WO>(acc2, b_big, b_small, big1 + wg_off, small1 + wg_off);\n",
         "      acc1[0] += __uint_as_float(" + KEEP_A + ");\n"
         "      acc2[0] += __uint_as_float(" + KEEP_A.replace("a_", "b_") + ");\n")],
    "wbwd_no_split": [(TRAIN, "    wide_split_rows<WO>(big1, small1, raw1, ld, ks);\n"
                              "    wide_split_rows<WO>(big2, small2, raw2, ld, ks);\n", "")],
    "wbwd_no_loads": [(TRAIN, "    if (it + 1 < ntiles) load_tile(j0 + BK);\n", "")],
    "wbwd_bounded": [(TRAIN, "      if (ks == KS)\n        scores(std::true_type{});\n      else\n"
                             "        scores(std::false_type{});\n",
                      "      scores(std::false_type{});\n")],
    "local_rows_no_copies": [ROWS, (LOCAL, "  if (warp == 0) fetch(blockIdx.x, 0);\n", ""),
                             (LOCAL, "    if (warp == 0 && u + gridDim.x < a.units) "
                                     "fetch(u + gridDim.x, s ^ 1);\n"
                                     "    mbar_wait(&bar[s], (it >> 1) & 1);\n", "")],
    "narrow_mma_sync": [(FLASH, "    return flash_narrow_launch<DHP>(a, s);",
                         "    return flash_launch<DHP, false>(a, s);")],
    "narrow_bk32": [(FLASH, "    if (a.T > 128) return flash_narrow_tiles<DHP, 64>(a, s);",
                     "    if (false) return flash_narrow_tiles<DHP, 64>(a, s);")],
    "narrow_bk64": [(FLASH, "    if (a.T > 128) return flash_narrow_tiles<DHP, 64>(a, s);",
                     "    if (true) return flash_narrow_tiles<DHP, 64>(a, s);")],
    "narrow_one_consumer": [
        (FLASH, "  static constexpr int NC = DHP <= 96 ? 2 : 1;    // consumer warpgroups",
         "  static constexpr int NC = 1;  // consumer warpgroups")],
    "narrow_no_split": [(FLASH, "      for (int it = 0; it < BK * DHP / 512; ++it) {",
                         "      for (int it = 0; it < 0; ++it) {")],
    "narrow_no_softmax": [
        (FLASH, "        sc[4 * n + e] = exp2f(sc[4 * n + e] - mn_lo);",
         "        sc[4 * n + e] = sc[4 * n + e] - mn_lo;"),
        (FLASH, "        sc[4 * n + 2 + e] = exp2f(sc[4 * n + 2 + e] - mn_hi);",
         "        sc[4 * n + 2 + e] = sc[4 * n + 2 + e] - mn_hi;")],
    "narrow_no_products": [
        (FLASH, "      wgmma_rs<BK>(sc, qbig[c], ds);\n"
                "      wgmma_ss<BK>(sc, wgmma_desc(qs + c * 512, 128, 256), db);\n"
                "      wgmma_rs<BK>(sc, qbig[c], db);\n",
         "      sc[c % (BK / 2)] += __uint_as_float(qbig[c][0] ^ qbig[c][1]);\n"),
        (FLASH, "      wgmma_rs<DHP>(o, p_big[set], ds);\n"
                "      wgmma_rs<DHP>(o, p_small[set], db);\n"
                "      wgmma_rs<DHP>(o, p_big[set], db);\n",
         "      o[n % (DHP / 2)] += __uint_as_float(p_big[set][0] ^ p_small[set][1]);\n")],
    "narrow_no_loads": [
        (FLASH, "          mbar_arrive_expect_tx(bar, static_cast<uint32_t>(2 * NB * BOX * "
                "sizeof(float)));", "          mbar_arrive(bar);"),
        (FLASH, "          for (int x = 0; x < NB; ++x) {\n            tma_load_4d(",
         "          for (int x = 0; x < 0; ++x) {\n            tma_load_4d(")],
})
WS, LAYER = "gemm_ws.cuh", "encoder_layer.cu"
VARIANTS.update({
    "ws_parent": [(LAYER, "int layer_routes(int D, int F) {\n",
                   "int layer_routes(int D, int F) {\n  if (D > 0) return 0;\n")],
    "ws_no_loads": [(WS, "          mbar_arrive_expect_tx(&full[s], Tile::kStageBytes);\n"
                         "          tma_load_2d(stage, &tma, ks * kWsBK, m0, &full[s]);\n"
                         "#pragma unroll\n          for (int part = 0; part < 2; ++part) {",
                     "          mbar_arrive(&full[s]);\n"
                     "#pragma unroll\n          for (int part = 0; part < 0; ++part) {")],
    "ws_no_a_split": [(WS, "        const float2 lo = ld2f(a + arow * kWsBK + col);\n"
                           "        const float2 hi = ld2f(a + (arow + 8) * kWsBK + col);\n"
                           "        split_tf32(lo.x, a_big[buf][0], a_small[buf][0]);\n"
                           "        split_tf32(hi.x, a_big[buf][1], a_small[buf][1]);\n"
                           "        split_tf32(lo.y, a_big[buf][2], a_small[buf][2]);\n"
                           "        split_tf32(hi.y, a_big[buf][3], a_small[buf][3]);\n",
                       "        a_big[buf][0] = a_big[buf][1] = a_big[buf][2] = a_big[buf][3] = col;\n"
                       "        a_small[buf][0] = a_small[buf][1] = a_small[buf][2] = "
                       "a_small[buf][3] = 0u;\n")],
    "ws_no_ln": [(LAYER, "  if (D <= kWsLnCols) r |= (r & 2) << 3 | (r & 8) << 2;\n", "")],
    "ws_ln_one_consumer": [(WS, "    return gemm_ws_launch<2, kWsLnCols, true, EPI, FLUSH>(",
                            "    return gemm_ws_launch<1, kWsLnCols, true, EPI, FLUSH>(")],
    "ws_cols": [(WS, "    return gemm_ws_launch<2, 128, false, EPI, FLUSH>(",
                 "    return gemm_ws_launch<2, 256, true, EPI, FLUSH>(")],
    "ws_no_short": [(WS, "    if (short_tiles <= wave) return gemm_ws_launch<2, 128, true, EPI, "
                         "FLUSH>(A, tmw, p, s);\n", "")],
    "train_parent": [(TRAIN, "int train_routes(int D, int F) {\n",
                      "int train_routes(int D, int F) {\n  if (D > 0) return 0;\n")],
})
VARIANTS["narrow_bare"] = (VARIANTS["narrow_no_loads"] + VARIANTS["narrow_no_products"]
                          + VARIANTS["narrow_no_softmax"] + VARIANTS["narrow_no_split"])
# the libraries each variant is timed through
LIBS = ("encoder_layer", "flash_attention", "band_attention", "local_block",
        "encoder_layer_train")
VARIANT_LIBS = {name: (("band_attention",) if name.startswith("band_") else
                       ("local_block",) if name.startswith("local_") else
                       ("encoder_layer", "flash_attention")) for name in VARIANTS}
VARIANT_LIBS["wide_sliced"] += ("encoder_layer_train",)
VARIANT_LIBS["band_sliced"] = ("band_attention", "local_block")
# the variants of the wide attention backward (the training library alone)
BWD_VARIANTS = ("wide_bwd_sliced", "wbwd_no_scores", "wbwd_no_outputs", "wbwd_no_split",
                "wbwd_no_loads", "wbwd_bounded")
for _name in BWD_VARIANTS:
    VARIANT_LIBS[_name] = ("encoder_layer_train",)
WS_VARIANTS = tuple(name for name in VARIANTS if name.startswith("ws_"))
for _name in WS_VARIANTS:
    VARIANT_LIBS[_name] = ("encoder_layer",)
VARIANT_LIBS["train_parent"] = ("encoder_layer_train",)


CSRC = os.path.join(HERE, "gesturediffusion_tpu_torch", "csrc")


def patched_sources(name: str, patches) -> dict[str, str]:
    """{file name: text} of the csrc/ files one variant changes, its patches
    applied in order (a whole file from tools/variants/ where ``old`` is
    None); raises where a patch no longer matches the sources."""
    files: dict[str, str] = {}
    for fname, old, new in patches:
        if old is None:  # the whole file, from tools/variants/
            with open(os.path.join(HERE, "tools", "variants", new)) as f:
                files[fname] = f.read()
            continue
        if fname not in files:
            with open(os.path.join(CSRC, fname)) as f:
                files[fname] = f.read()
        if old not in files[fname]:
            raise RuntimeError(f"variant {name}: {fname} no longer holds {old!r}")
        files[fname] = files[fname].replace(old, new)
    return files


def start_build(name: str, patches, libs=LIBS) -> dict:
    """Starts nvcc on each library of one variant; finish_build waits."""
    from gesturediffusion_tpu_torch.ops import _build

    src = _build.CSRC_DIR
    if patches is not None:
        files = patched_sources(name, patches)
        src = os.path.join(HERE, "build", "variants", name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, src)
        for fname, text in files.items():
            with open(os.path.join(src, fname), "w") as f:
                f.write(text)
    out = os.path.join(HERE, "build", "variants", name + "-lib")
    os.makedirs(out, exist_ok=True)
    return {k: (os.path.join(out, f"lib{k}.so"),
                subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                  os.path.join(out, f"lib{k}.so"), os.path.join(src, k + ".cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for k in libs}


def finish_build(name: str, procs: dict) -> dict[str, ctypes.CDLL]:
    libs = {}
    for k, (path, p) in procs.items():
        report, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {k}.cu\n{report}")
        libs[k] = ctypes.CDLL(path)
    return libs


_TRAIN_MAPS = {}  # (library, weights) -> their splits and maps, held


def train_maps(lib, w, backward):
    """The maps of w's weight splits (W's, then with ``backward`` W^T's) by
    the library's own split kernels, None where its train_routes sends a
    weight to the parent GEMM, as ops/fused_encoder_train.py passes them."""
    import torch

    entry = _TRAIN_MAPS.get((id(lib), id(w)))
    if entry is None or entry[0] is not w:
        routes = lib.gdt_encoder_layer_train_routes
        routes.argtypes = [ctypes.c_int] * 2
        on = routes(w[0].shape[1], w[6].shape[0])
        held = []
        for name in ("gdt_split_weight_f32", "gdt_split_weight_t_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
            for i, j in enumerate((0, 2, 6, 8)):
                if not on >> i & 1:
                    held.append(None)
                    continue
                n, k = w[j].shape if name == "gdt_split_weight_f32" else w[j].shape[::-1]
                split = torch.empty(2, n, (k + 7) // 8 * 8, device="cuda")
                tmap = ctypes.create_string_buffer(lib.gdt_tensor_map_bytes())
                code = fn(w[j].data_ptr(), split.data_ptr(), n, k, ctypes.addressof(tmap),
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"weight split failed: CUDA error {code}")
                held.append((split, tmap))
        entry = _TRAIN_MAPS[(id(lib), id(w))] = (w, held)
    maps = [None if h is None else ctypes.addressof(h[1]) for h in entry[1]]
    return maps if backward else maps[:4]


def train_layer(lib, x, w, seed, g=None, heads=4, rate=0.1):
    """Kernel 5 (g None: the output) or kernel 6 (dx and the 12 weight
    gradients for the output gradient g) of one build, called as
    ops/fused_encoder_train.py calls them."""
    import torch

    from gesturediffusion_tpu_torch.ops import fused_encoder_train as fet

    backward = g is not None
    fn = lib.gdt_encoder_layer_train_bwd_f32 if backward else lib.gdt_encoder_layer_train_fwd_f32
    fn.argtypes = fet._BWD_ARGS if backward else fet._FWD_ARGS
    ws_floats = lib.gdt_encoder_layer_train_workspace
    ws_floats.argtypes, ws_floats.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    b, t, d = x.shape
    f, keep = w[6].shape[0], 1.0 - rate
    ws = torch.empty(ws_floats(b, t, d, f, heads, int(backward)), device="cuda")
    tail = (b, t, d, f, heads, (d // heads) ** -0.5, fet.keep_threshold(keep), 1.0 / keep,
            int(rate > 0.0), 0, *train_maps(lib, w, backward),
            torch.cuda.current_stream().cuda_stream)
    ptrs = [x.data_ptr(), *(y.data_ptr() for y in w), seed.data_ptr()]
    if backward:
        outs = (torch.empty_like(x), *(torch.empty_like(y) for y in w))
        code = fn(*ptrs, g.data_ptr(), *(o.data_ptr() for o in outs), ws.data_ptr(), *tail)
    else:
        outs = (torch.empty_like(x),)
        code = fn(*ptrs, outs[0].data_ptr(), ws.data_ptr(), *tail)
    if code:
        raise RuntimeError(f"training layer variant failed: CUDA error {code}")
    return outs


def train_parent_ab(builds, order, rn, cuda_ms, smi, heads=4, rate=0.1):
    """train_parent's rows: kernels 5 and 6 at their shipped shapes in the
    turns of ``order``, each output against the first turn's bit for bit,
    with the profiler's device time of their products."""
    import torch

    from chip_smoke import device_split

    seed = torch.tensor([20240], dtype=torch.int32, device="cuda")
    for b, t, d in ((64, 81, 256), (64, 121, 256), (64, 197, 512), (64, 61, 512)):
        ff = 1024
        w = (rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.02), rn(d, d, scale=d**-0.5),
             rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.1), rn(ff, d, scale=d**-0.5),
             rn(ff, scale=0.02), rn(d, ff, scale=ff**-0.5), rn(d, scale=0.02),
             1 + rn(d, scale=0.1), rn(d, scale=0.1))
        x, g = rn(b, t, d), rn(b, t, d)
        for what, gg in (("kernel 5", None), ("kernel 6", g)):
            parts, first = [], None
            for name in order:
                lib = builds[name]["encoder_layer_train"]
                got = train_layer(lib, x, w, seed, gg, heads, rate)
                first = first or got
                same = all(torch.equal(a, c) for a, c in zip(got, first))
                ms = cuda_ms(lambda: train_layer(lib, x, w, seed, gg, heads, rate), 20)
                _, kernels = device_split(lambda: train_layer(lib, x, w, seed, gg, heads, rate),
                                          10, "gemm_")
                gemm = sum(k for n, (k, _) in kernels.items() if "gemm_" in n)
                parts.append(f"{name} {ms:.4f} ms, products {gemm:.4f} device (bit for bit: "
                             f"{same})")
            print(f"{what} [{b},{t},{d}] heads {heads} ff {ff} rate {rate}: " + "; ".join(parts)
                  + f" [{smi}]", flush=True)
        del x, g, w
    _TRAIN_MAPS.clear()


def train_ab(builds, order, w, rn, cuda_ms, smi, heads=4, rate=0.1):
    """wide_sliced's training rows: kernels 5 and 6 at [64, 81, 1024] in the
    turns of ``order``, against the plain layer (forward; autograd's
    gradients), beside the SDPA layer's forward and forward + backward."""
    import torch

    from chip_smoke import encoder_layer_sdpa
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import encoder_layer_train_plain

    d = w[0].shape[1]
    x, g = rn(64, 81, d), rn(64, 81, d)
    seed = torch.tensor([20240], dtype=torch.int32, device="cuda")
    tx, tw = x.clone().requires_grad_(), [y.clone().requires_grad_() for y in w]
    with torch.enable_grad():
        want_fwd = encoder_layer_train_plain(tx, *tw, seed=seed, num_heads=heads, rate=rate)
        want_bwd = torch.autograd.grad(want_fwd, [tx, *tw], g)

    def sdpa_fwd_bwd():
        with torch.enable_grad():
            encoder_layer_sdpa(tx, *tw, heads, rate=rate).backward(g)

    for what, want, gg, sdpa in (
            ("forward", (want_fwd.detach(),), None,
             lambda: encoder_layer_sdpa(x, *w, heads, rate=rate)),
            ("forward + backward", want_bwd, g, sdpa_fwd_bwd)):
        parts = []
        for name in order:
            lib = builds[name]["encoder_layer_train"]
            got = train_layer(lib, x, w, seed, gg, heads, rate)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            ms = cuda_ms(lambda: train_layer(lib, x, w, seed, gg, heads, rate), 10)
            parts.append(f"{name} {ms:.4f} ms (max|diff| {err:.2e})")
        lib_ms = cuda_ms(sdpa, 10)
        print(f"training layer {what} [64,81,{d}] heads {heads} of {d // heads} ff "
              f"{w[6].shape[0]} rate {rate}: " + "; ".join(parts)
              + f"; the SDPA layer {lib_ms:.4f} ms [{smi}]", flush=True)


def wide_bwd_ab(builds, order, rn, cuda_ms, smi, heads=4, rate=0.1, ff=1024):
    """wide_bwd_sliced's rows: kernel 6 at [64, 81, d] for d 1024 and 2080
    in the turns of ``order`` (CUDA events, and its attention backward's
    passes by the profiler's device time inside it), against autograd
    through the plain layer, beside the SDPA layer's forward + backward and
    SDPA's attention backward alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ATTN_BWD_KERNELS, encoder_layer_sdpa, sdpa_backward_ms
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import encoder_layer_train_plain

    def passes_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CPU
                    and any(k in e.key for _, k in ATTN_BWD_KERNELS)):
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
        return us / iters / 1e3

    seed = torch.tensor([20240], dtype=torch.int32, device="cuda")
    for d in (1024, 2080):
        w = (rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.02), rn(d, d, scale=d**-0.5),
             rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.1), rn(ff, d, scale=d**-0.5),
             rn(ff, scale=0.02), rn(d, ff, scale=ff**-0.5), rn(d, scale=0.02),
             1 + rn(d, scale=0.1), rn(d, scale=0.1))
        x, g = rn(64, 81, d), rn(64, 81, d)
        tx, tw = x.clone().requires_grad_(), [y.clone().requires_grad_() for y in w]
        with torch.enable_grad():
            want = torch.autograd.grad(
                encoder_layer_train_plain(tx, *tw, seed=seed, num_heads=heads, rate=rate),
                [tx, *tw], g)
        parts = []
        for name in order:
            lib = builds[name]["encoder_layer_train"]
            got = train_layer(lib, x, w, seed, g, heads, rate)
            err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
            note = "not checked" if name.startswith("wbwd_no_") else f"{err:.2e}"
            ms = cuda_ms(lambda: train_layer(lib, x, w, seed, g, heads, rate), 10)
            p_ms = passes_ms(lambda: train_layer(lib, x, w, seed, g, heads, rate))
            parts.append(f"{name} {ms:.4f} ms, its attention passes {p_ms:.4f} ms (worst "
                         f"max|diff|/max|grad| {note})")

        def sdpa_layer():
            with torch.enable_grad():
                encoder_layer_sdpa(tx, *tw, heads, rate=rate).backward(g)

        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            lib_ms = cuda_ms(sdpa_layer, 10)
            bwd_ms = sdpa_backward_ms(64, 81, d // heads)
        print(f"kernel 6 [64,81,{d}] heads {heads} of {d // heads} ff {ff} rate {rate}: "
              + "; ".join(parts) + f"; the SDPA layer forward + backward {lib_ms:.4f} ms, "
              f"SDPA's attention backward alone {bwd_ms:.4f} ms [{smi}]", flush=True)
        del w, x, g, tx, tw, want


def band_ab(builds, order, rn, cuda_ms, smi):
    """band_sliced's rows: the band kernel at [82, 8, 1200, dh] (dh 136 and
    264, q = k = v strided, window 10; dh 128 at window 60) and the local
    block at [82, 80, 8 dh] (dh 136 and 264) in the turns of ``order``,
    device time a call by the profiler, against the plain twins, beside the
    plain twins' and the library's times by CUDA events."""
    import torch

    from chip_smoke import band_sdpa, device_split, local_block_sdpa
    from gesturediffusion_tpu_torch.ops.fused_local_block import (
        pre_encoder_local_block,
        rotary_table,
    )
    from gesturediffusion_tpu_torch.ops.local_attention import local_attention

    def band(lib, q, w):
        fn = lib.gdt_band_attention_f32
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [ll] * 12 + [i] * 5 + [ctypes.c_float, p]
        out = torch.empty_like(q)
        b, h, t, dh = q.shape
        code = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), *q.stride()[:3] * 3,
                  *out.stride()[:3], b, h, t, dh, w, dh**-0.5,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"band variant failed: CUDA error {code}")
        return out

    def local(lib, x, coa):
        fn = lib.gdt_local_block_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 5 + [ctypes.c_float, p]
        ws_floats = lib.gdt_local_block_workspace
        ws_floats.argtypes, ws_floats.restype = [i] * 4, ctypes.c_size_t
        b, t, dd = x.shape
        cos, sin = rotary_table(t + 1, dd // 8, x.device)
        out = torch.empty(b, t + 1, dd, device="cuda")
        n = ws_floats(b, t, dd, 8)
        ws = torch.empty(n, device="cuda") if n else None
        code = fn(x.data_ptr(), coa.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), b, t, dd, 8, 10, (dd // 8) ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"local block variant failed: CUDA error {code}")
        return out

    for dh, w in ((136, 10), (264, 10), (128, 60)):
        q = rn(82, 1200, 8, dh).transpose(1, 2)
        want = local_attention(q, q, q, window_size=w)
        parts = []
        for name in order:
            lib = builds[name]["band_attention"]
            err = (band(lib, q, w) - want).abs().max().item()
            ms, _ = device_split(lambda: band(lib, q, w))
            parts.append(f"{name} {ms:.4f} ms (max|diff| {err:.2e})")
        plain = cuda_ms(lambda: local_attention(q, q, q, window_size=w), 3)
        sdpa = cuda_ms(lambda: band_sdpa(q, w), 3)
        print(f"band [82,8,1200,{dh}] w {w} (q = k = v strided), device: " + "; ".join(parts)
              + f"; plain {plain:.4f} ms, band-masked SDPA {sdpa:.4f} ms [{smi}]", flush=True)
        del q, want
    for dh in (136, 264):
        x, coa = rn(82, 80, 8 * dh), rn(82, 8 * dh)
        want = pre_encoder_local_block(x, coa, num_heads=8, window_size=10)
        parts = []
        for name in order:
            lib = builds[name]["local_block"]
            err = (local(lib, x, coa) - want).abs().max().item()
            ms, names = device_split(lambda: local(lib, x, coa))
            parts.append(f"{name} {ms:.4f} ms in {sum(n for _, n in names.values()):g} "
                         f"launches (max|diff| {err:.2e})")
        plain = cuda_ms(lambda: pre_encoder_local_block(x, coa, num_heads=8, window_size=10))
        sdpa = cuda_ms(lambda: local_block_sdpa(x, coa, 8, 10))
        print(f"local block [82,80,{8 * dh}] heads 8 of {dh} w 10, device: " + "; ".join(parts)
              + f"; plain {plain:.4f} ms, the SDPA block {sdpa:.4f} ms [{smi}]", flush=True)
        del x, coa, want


def narrow_ab(builds, order, rn, cuda_ms, smi, flash, layer):
    """The narrow_* rows: the flash forward alone and kernel 1 at their
    shipped shapes up to a head width of 128 in the turns of ``order``,
    each beside the plain twin, the library call and the bound."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import bound_ms, device_split, encoder_layer_sdpa
    from gesturediffusion_tpu_torch.ops.flash_attention import self_attention_reference
    from gesturediffusion_tpu_torch.ops.fused_encoder import encoder_layer_plain

    for shape in ((82, 4, 81, 64), (82, 4, 1201, 64), (82, 4, 1201, 80), (6, 4, 197, 128),
                  (64, 4, 197, 128), (32, 4, 197, 128)):
        q, k, v = (rn(*shape) for _ in range(3))
        want = self_attention_reference(q, k, v)
        b, h, t, dh = shape
        iters = 5 if t > 1000 else 50
        parts = []
        for name in order:
            lib = builds[name]["flash_attention"]
            err = (flash(lib, q, k, v) - want).abs().max().item()
            ms = cuda_ms(lambda: flash(lib, q, k, v), iters)
            dev, _ = device_split(lambda: flash(lib, q, k, v), 10)
            parts.append(f"{name} {ms:.4f} ms, device {dev:.4f} (max|diff| {err:.2e})")
        plain = cuda_ms(lambda: self_attention_reference(q, k, v), 5)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
        bound, by = bound_ms(4 * b * h * t * t * dh, 4 * 4 * q.numel(), tf32x3=True)
        print(f"flash {list(shape)}: " + "; ".join(parts) + f"; plain {plain:.4f} ms, "
              f"F.scaled_dot_product_attention {sdpa:.4f} ms, bound {bound:.4f} ms ({by}) "
              f"[{smi}]", flush=True)
        del q, k, v, want
    for b, t, d in ((82, 81, 256), (6, 197, 512), (64, 197, 512), (32, 197, 512), (64, 61, 512),
                    (12, 61, 512)):
        ff = 1024
        w = (rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.02), rn(d, d, scale=d**-0.5),
             rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.1), rn(ff, d, scale=d**-0.5),
             rn(ff, scale=0.02), rn(d, ff, scale=ff**-0.5), rn(d, scale=0.02),
             1 + rn(d, scale=0.1), rn(d, scale=0.1))
        x = rn(b, t, d)
        want = encoder_layer_plain(x, *w, num_heads=4)
        parts = []
        for name in order:
            lib = builds[name]["encoder_layer"]
            err = (layer(lib, x, w) - want).abs().max().item()
            ms = cuda_ms(lambda: layer(lib, x, w), 50)
            parts.append(f"{name} {ms:.4f} ms (max|diff| {err:.2e})")
        plain = cuda_ms(lambda: encoder_layer_plain(x, *w, num_heads=4), 10)
        sdpa = cuda_ms(lambda: encoder_layer_sdpa(x, *w, 4), 50)
        m = b * t
        bound, by = bound_ms(2 * m * (4 * d * d + 2 * d * ff) + 4 * b * t * t * d,
                             4 * (2 * m * d + sum(y.numel() for y in w)), tf32x3=True)
        print(f"encoder layer [{b},{t},{d}] heads 4 ff {ff}: " + "; ".join(parts)
              + f"; plain {plain:.4f} ms, the SDPA layer {sdpa:.4f} ms, bound {bound:.4f} ms "
              f"({by}) [{smi}]", flush=True)
        del x, w, want


def ws_ab(builds, order, rn, cuda_ms, smi, layer):
    """The ws_* rows: kernel 1 at its shipped shapes up to D 512 in the
    turns of ``order`` (CUDA events, and the device time of its products)."""
    from chip_smoke import bound_ms, device_split, encoder_layer_sdpa
    from gesturediffusion_tpu_torch.ops.fused_encoder import encoder_layer_plain

    checked = ("shipped", "ws_parent", "ws_no_ln", "ws_ln_one_consumer", "ws_cols",
               "ws_no_short")
    for b, t, d in ((82, 81, 256), (6, 197, 512), (64, 197, 512), (32, 197, 512), (64, 61, 512),
                    (12, 61, 512)):
        ff = 1024
        w = (rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.02), rn(d, d, scale=d**-0.5),
             rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.1), rn(ff, d, scale=d**-0.5),
             rn(ff, scale=0.02), rn(d, ff, scale=ff**-0.5), rn(d, scale=0.02),
             1 + rn(d, scale=0.1), rn(d, scale=0.1))
        x = rn(b, t, d)
        want = encoder_layer_plain(x, *w, num_heads=4)
        parts = []
        for name in order:
            lib = builds[name]["encoder_layer"]
            got = layer(lib, x, w)
            note = f"{(got - want).abs().max().item():.2e}" if name in checked else "not checked"
            ms = cuda_ms(lambda: layer(lib, x, w), 50)
            _, kernels = device_split(lambda: layer(lib, x, w), 10, "gemm")
            gemm = sum(k for n, (k, _) in kernels.items() if "gemm_" in n)
            parts.append(f"{name} {ms:.4f} ms, products {gemm:.4f} device (max|diff| {note})")
        plain = cuda_ms(lambda: encoder_layer_plain(x, *w, num_heads=4), 10)
        sdpa = cuda_ms(lambda: encoder_layer_sdpa(x, *w, 4), 50)
        m = b * t
        bound, by = bound_ms(2 * m * (4 * d * d + 2 * d * ff) + 4 * b * t * t * d,
                             4 * (2 * m * d + sum(y.numel() for y in w)), tf32x3=True)
        pbound, _ = bound_ms(2 * m * (4 * d * d + 2 * d * ff), 0, tf32x3=True)
        print(f"encoder layer [{b},{t},{d}] heads 4 ff {ff}: " + "; ".join(parts)
              + f"; plain {plain:.4f} ms, the SDPA layer {sdpa:.4f} ms, bound {bound:.4f} ms "
              f"({by}), the products' bound {pbound:.4f} ms [{smi}]", flush=True)
        del x, w, want


def products_ab(rn, smi):
    """The products row: each of kernel 1's four products alone, gemm_ws.cuh
    against the parent GEMM and F.linear in full f32, by the profiler's
    device time a launch, beside its bound."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import bound_ms, device_split
    from gesturediffusion_tpu_torch.ops.fused_encoder import layer_product

    for m, d in ((6642, 256), (12608, 512)):
        ff = 1024
        rows = []
        for name, n, k, epi in (("qkv", 3 * d, d, "bias"),
                                ("out", d, d, "ln" if d <= 256 else "resid"),
                                ("ff1", ff, d, "gelu"),
                                ("ff2", d, ff, "ln" if d <= 256 else "resid")):
            a, w, bias, resid = rn(m, k), rn(n, k, scale=k**-0.5), rn(n, scale=0.02), rn(m, n)
            ln = (1 + rn(n, scale=0.1), rn(n, scale=0.1))
            new, _ = device_split(lambda: layer_product(a, w, bias, epi=epi, resid=resid, ln=ln),
                                  20, "gemm_ws")
            pe = "resid" if epi == "ln" else epi
            old, _ = device_split(lambda: layer_product(a, w, bias, epi=pe, resid=resid,
                                                        parent=True), 20, "gemm_tf32x3")
            lib, _ = device_split(lambda: F.linear(a, w, bias), 20)
            bound, _ = bound_ms(2 * m * n * k, 0, tf32x3=True)
            rows.append(f"{name} [{m},{n},{k}] {epi}: gemm_ws {new:.4f} ms ({bound / new:.2f} of "
                        f"the bound), parent {old:.4f}, F.linear f32 {lib:.4f}, bound {bound:.4f}")
            del a, w, bias, resid
        print(f"products D {d}: " + "; ".join(rows) + f" [{smi}]", flush=True)


def main(prefixes: list[str]) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    from gesturediffusion_tpu_torch.ops.flash_attention import self_attention_reference
    from gesturediffusion_tpu_torch.ops.fused_encoder import encoder_layer_plain
    from gesturediffusion_tpu_torch.ops.fused_local_block import (
        pre_encoder_local_block,
        rotary_table,
    )
    from gesturediffusion_tpu_torch.ops.local_attention import local_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    chosen = [name for name in VARIANTS if not prefixes or name.startswith(tuple(prefixes))]
    # the backward's variants alone need only the training library, the
    # band's A/B alone the band and local-block libraries
    only_bwd = all(name in BWD_VARIANTS for name in chosen)
    only_band = chosen == ["band_sliced"]
    only_narrow = all(name.startswith("narrow_") for name in chosen)
    only_ws = all(name.startswith("ws_") for name in chosen)
    only_train = chosen == ["train_parent"]
    # every variant's nvcc runs at once
    started = {"shipped": start_build("shipped", None,
                                      ("encoder_layer_train",) if only_bwd else
                                      VARIANT_LIBS["band_sliced"] if only_band else
                                      VARIANT_LIBS["narrow_mma_sync"] if only_narrow else
                                      ("encoder_layer",) if only_ws else
                                      ("encoder_layer_train",) if only_train else LIBS)}
    started.update({name: start_build(name, VARIANTS[name], VARIANT_LIBS[name])
                    for name in chosen})
    builds = {name: finish_build(name, procs) for name, procs in started.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    if "train_parent" in builds:
        train_parent_ab(builds, ("shipped", "train_parent", "train_parent", "shipped"), rn,
                        cuda_ms, smi)
    if only_train:
        return 0
    if "band_sliced" in builds:
        band_ab(builds, ("shipped", "band_sliced", "band_sliced", "shipped"), rn, cuda_ms, smi)
    if only_band:
        return 0
    if "wide_bwd_sliced" in builds:
        wide_bwd_ab(builds, ("shipped", "wide_bwd_sliced", "wide_bwd_sliced", "shipped"), rn,
                    cuda_ms, smi)
    ablations = [name for name in BWD_VARIANTS[1:] if name in builds]
    if ablations:
        wide_bwd_ab(builds, ("shipped", *ablations, *ablations[::-1], "shipped"), rn, cuda_ms,
                    smi)
    if only_bwd:
        return 0

    d, ff, heads = 256, 1024, 4
    w = (rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.02), rn(d, d, scale=d**-0.5),
         rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.1), rn(ff, d, scale=d**-0.5),
         rn(ff, scale=0.02), rn(d, ff, scale=ff**-0.5), rn(d, scale=0.02), 1 + rn(d, scale=0.1),
         rn(d, scale=0.1))

    splits = {}  # (library, weights) -> the four weights' splits and maps

    def weight_maps(lib, w):
        """the maps of w's four weight splits by the library's own split"""
        entry = splits.get((id(lib), id(w)))
        if entry is None or entry[0] is not w:
            fn = lib.gdt_split_weight_f32
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
            held = []
            for y in (w[0], w[2], w[6], w[8]):
                n, k = y.shape
                split = torch.empty(2, n, (k + 7) // 8 * 8, device="cuda")
                tmap = ctypes.create_string_buffer(lib.gdt_tensor_map_bytes())
                code = fn(y.data_ptr(), split.data_ptr(), n, k, ctypes.addressof(tmap),
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"weight split failed: CUDA error {code}")
                held.append((split, tmap))
            entry = splits[(id(lib), id(w))] = (w, held)
        return [ctypes.addressof(tmap) for _, tmap in entry[1]]

    def layer(lib, x, w=w):
        fn = lib.gdt_encoder_layer_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 19 + [i] * 5 + [ctypes.c_float] + [p] * 5
        b, t, d = x.shape
        ff = w[6].shape[0]
        new = functools.partial(torch.empty, device="cuda")
        bufs = (new(b * t, 3 * d), new(b * t, d), new(b * t, d), new(b * t, d), new(b * t, ff))
        out = new(b, t, d)
        code = fn(x.data_ptr(), *(y.data_ptr() for y in w), *(y.data_ptr() for y in bufs),
                  out.data_ptr(), b, t, d, ff, heads, (d // heads) ** -0.5,
                  *weight_maps(lib, w), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"encoder layer variant failed: CUDA error {code}")
        return out

    def flash(lib, q, k, v):
        fn = lib.gdt_flash_attention_f32
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [ll] * 12 + [i] * 4 + [ctypes.c_float, p]
        out = torch.empty_like(q)
        b, h, t, dh = q.shape
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *q.stride()[:3],
                  *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], b, h, t, dh, dh**-0.5,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"flash variant failed: CUDA error {code}")
        return out

    narrow = [name for name in chosen if name.startswith("narrow_")]
    if narrow:
        narrow_ab(builds, ("shipped", *narrow, *narrow[::-1], "shipped"), rn, cuda_ms, smi,
                  flash, layer)
    if only_narrow:
        return 0
    ws = [name for name in chosen if name.startswith("ws_")]
    if ws:
        ws_ab(builds, ("shipped", *ws, *ws[::-1], "shipped"), rn, cuda_ms, smi, layer)
        products_ab(rn, smi)
    if only_ws:
        return 0

    def device_ms(fn, kernel, iters=20):
        """the profiler's device time of the kernel, per launch it traced"""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if kernel in e.key and e.device_type != torch.autograd.DeviceType.CPU:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
                n += e.count
        if n != iters:
            print(f"device_ms: the profiler traced {n} of {iters} {kernel} launches")
        return us / max(n, 1) / 1e3

    def gemm_ms(lib, x):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                layer(lib, x)
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if "gemm_" in e.key and e.device_type != torch.autograd.DeviceType.CPU:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
        return us / 5 / 1e3

    for t in (81, 1201):
        x = rn(82, t, d)
        want = encoder_layer_plain(x, *w, num_heads=heads)
        parts = []
        for name, libs in builds.items():
            if "encoder_layer" not in libs:
                continue
            err = (layer(libs["encoder_layer"], x) - want).abs().max().item()
            ms = cuda_ms(lambda: layer(libs["encoder_layer"], x))
            note = (f"{err:.2e}" if not name.startswith(("ws_no_loads", "ws_no_a"))
                    else "not checked")
            extra = f", products {gemm_ms(libs['encoder_layer'], x):.4f} ms" if t > 81 else ""
            parts.append(f"{name} {ms:.4f} ms (max|diff| {note}{extra})")
        print(f"encoder layer [82,{t},{d}]: " + "; ".join(parts) + f" [{smi}]", flush=True)

    q, k, v = (rn(82, heads, 1201, d // heads) for _ in range(3))
    want = self_attention_reference(q, k, v)
    parts = []
    for name in ("shipped", "cvt_rounding"):
        if name not in builds:
            continue
        lib = builds[name]["flash_attention"]
        err = (flash(lib, q, k, v) - want).abs().max().item()
        parts.append(f"{name} {cuda_ms(lambda: flash(lib, q, k, v)):.4f} ms (max|diff| {err:.2e})")
    print(f"flash [82,{heads},1201,{d // heads}]: " + "; ".join(parts) + f" [{smi}]")

    if "wide_sliced" in builds:
        order = ("shipped", "wide_sliced", "wide_sliced", "shipped")
        for dh in (256, 520):
            q, k, v = (rn(82, heads, 1201, dh) for _ in range(3))
            want = self_attention_reference(q, k, v)
            parts = []
            for name in order:
                lib = builds[name]["flash_attention"]
                err = (flash(lib, q, k, v) - want).abs().max().item()
                ms = cuda_ms(lambda: flash(lib, q, k, v), 5)
                parts.append(f"{name} {ms:.4f} ms (max|diff| {err:.2e})")
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 5)
            print(f"flash [82,{heads},1201,{dh}]: " + "; ".join(parts)
                  + f"; F.scaled_dot_product_attention {sdpa:.4f} ms [{smi}]", flush=True)
            del q, k, v, want
        dw = 4 * 256
        ww = (rn(3 * dw, dw, scale=dw**-0.5), rn(3 * dw, scale=0.02), rn(dw, dw, scale=dw**-0.5),
              rn(dw, scale=0.02), 1 + rn(dw, scale=0.1), rn(dw, scale=0.1),
              rn(ff, dw, scale=dw**-0.5), rn(ff, scale=0.02), rn(dw, ff, scale=ff**-0.5),
              rn(dw, scale=0.02), 1 + rn(dw, scale=0.1), rn(dw, scale=0.1))
        x = rn(82, 1201, dw)
        want = encoder_layer_plain(x, *ww, num_heads=heads)
        parts = []
        for name in order:
            lib = builds[name]["encoder_layer"]
            err = (layer(lib, x, ww) - want).abs().max().item()
            ms = cuda_ms(lambda: layer(lib, x, ww), 3)
            parts.append(f"{name} {ms:.4f} ms (max|diff| {err:.2e})")
        print(f"encoder layer [82,1201,{dw}] heads {heads} of {dw // heads} ff {ff}: "
              + "; ".join(parts) + f" [{smi}]", flush=True)
        del x, want
        train_ab(builds, order, ww, rn, cuda_ms, smi)

    def band(lib, q):
        fn = lib.gdt_band_attention_f32
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [ll] * 12 + [i] * 5 + [ctypes.c_float, p]
        out = torch.empty_like(q)
        b, h, t, dh = q.shape
        code = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), *q.stride()[:3] * 3,
                  *out.stride()[:3], b, h, t, dh, 10, dh**-0.5,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"band variant failed: CUDA error {code}")
        return out

    def local(lib, x, coa):
        fn = lib.gdt_local_block_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 5 + [ctypes.c_float, p]
        b, t, dd = x.shape
        cos, sin = rotary_table(t + 1, dd // 8, x.device)
        out = torch.empty(b, t + 1, dd, device="cuda")
        # the shapes timed here fit one block: no workspace
        code = fn(x.data_ptr(), coa.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                  None, b, t, dd, 8, 10, (dd // 8) ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"local block variant failed: CUDA error {code}")
        return out

    qb = rn(82, 1200, 8, d // 8).transpose(1, 2)
    want = local_attention(qb, qb, qb, window_size=10)
    parts = []
    for name in ("shipped", "band_no_math", "band_no_loads", "band_5_blocks", "band_6_blocks",
                 "band_q_split_once", "band_pv_two_acc", "band_rz_split"):
        if name not in builds:
            continue
        lib = builds[name]["band_attention"]
        checked = name.endswith(("shipped", "rz_split", "split_once"))
        note = f"{(band(lib, qb) - want).abs().max().item():.2e}" if checked else "not checked"
        ms = device_ms(lambda: band(lib, qb), "band_attention_kernel")
        parts.append(f"{name} {ms:.4f} ms (max|diff| {note})")
    print(f"band [82,8,1200,{d // 8}] w 10: " + "; ".join(parts) + f" [{smi}]")

    # the gesture shape, then the local heads of 40 of --latent_dim 320
    for dd, names in ((d, ("shipped", "local_q_split_once", "local_uncapped", "local_5_blocks",
                           "local_cap_all", "local_no_attention", "local_rz_split", "local_rows",
                           "local_rows_no_attention", "local_rows_no_copies")),
                      (320, ("shipped", "local_uncapped", "local_cap_all"))):
        x, coa = rn(82, 80, dd), rn(82, dd)
        want = pre_encoder_local_block(x, coa, num_heads=8, window_size=10)
        parts = []
        for name in names:
            if name not in builds:
                continue
            lib = builds[name]["local_block"]
            checked = name.endswith(("shipped", "rz_split", "split_once", "uncapped", "cap_all",
                                     "rows"))
            note = (f"{(local(lib, x, coa) - want).abs().max().item():.2e}" if checked
                    else "not checked")
            ms = device_ms(lambda: local(lib, x, coa), "local_block_kernel", 100)
            parts.append(f"{name} {ms:.4f} ms (max|diff| {note})")
        print(f"local block [82,80,{dd}] heads 8 w 10: " + "; ".join(parts) + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
