#!/usr/bin/env python3
"""Ceilings of the TF32 tensor-core instructions of the port's kernels.

The inference encoder layer's GEMM (gesturediffusion_tpu_torch/csrc/
gemm_tf32x3.cuh) runs its products as wgmma m64n64k8 TF32 and the flash
kernel (flash_attention.cuh) as mma.sync.m16n8k8 TF32, both in three passes
(3xTF32).  This script times each instruction alone, through the kernels'
own wrappers (it includes gemm_tf32x3.cuh): mma.sync as 8 independent
accumulator chains a warp on register operands, once without and once with
the 3xTF32 split of each operand (3 ALU operations per element, as the
kernels do); wgmma as the GEMM issues it a stage (4 k8 steps x 3 passes
from one B tile in shared memory, then a wait), nothing read from device
memory.  At 4, 8 and 16 warps per SM it prints the TF32 rate and the
f32-equivalent rate of three passes (one third of it).  Run it on the card
from the repository root:

    python3 tools/tf32_ceiling.py

It builds its kernel with nvcc into build/kernels/ and needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = r"""
#include "gemm_tf32x3.cuh"

namespace {

// each warp: iters x 8 chains x 3 mma; SPLIT re-splits the B operand of
// every chain each step (the per-fragment work of the 3xTF32 kernels)
template <bool SPLIT>
__global__ void mma_ceiling_kernel(float* out, int iters, float seed) {
  float acc[8][4] = {};
  uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
  for (int e = 0; e < 4; ++e) split_tf32(seed * (threadIdx.x + e), a_big[e], a_small[e]);
  const float bx = seed * threadIdx.x, by = seed * (threadIdx.x + 1);
  split_tf32(bx, b_big[0], b_small[0]);
  split_tf32(by, b_big[1], b_small[1]);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (SPLIT) {
        split_tf32(bx + c, b_big[0], b_small[0]);
        split_tf32(by + c, b_big[1], b_small[1]);
      }
      mma_tf32x3(acc[c], a_big, a_small, b_big, b_small);
    }
  }
  float s = 0.0f;
  for (int c = 0; c < 8; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// each warpgroup: iters x the GEMM's stage of wgmma (4 k8 steps x 3 passes
// of m64n64k8, A from registers, B big and small tiles in shared memory),
// then one wait, as gemm_tf32x3_kernel issues them
__global__ void wgmma_ceiling_kernel(float* out, int iters, float seed) {
  __shared__ __align__(128) float b[2][kTcBK * kTcBN];
  for (int i = threadIdx.x; i < 2 * kTcBK * kTcBN; i += blockDim.x)
    (&b[0][0])[i] = __uint_as_float(tf32_rn(seed * (i & 63)));
  fence_proxy_async();
  __syncthreads();
  float acc[32] = {};
  uint32_t a_big[4], a_small[4];
  for (int e = 0; e < 4; ++e) split_tf32(seed * (threadIdx.x + e), a_big[e], a_small[e]);
  const uint64_t desc_big = wgmma_desc(b[0], kTcLbo, kTcSbo);
  const uint64_t desc_small = wgmma_desc(b[1], kTcLbo, kTcSbo);
  for (int i = 0; i < iters; ++i) {
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t step = (uint64_t)(s * kTcSlice * sizeof(float)) >> 4;
      wgmma_m64n64k8_tf32(acc, a_big, desc_small + step);
      wgmma_m64n64k8_tf32(acc, a_small, desc_big + step);
      wgmma_m64n64k8_tf32(acc, a_big, desc_big + step);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  }
  float s = 0.0f;
  for (int i = 0; i < 32; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind 0: mma.sync, 1: mma.sync with the split, 2: wgmma; returns ms or -1
extern "C" float gdt_tf32_ceiling(float* out, int blocks, int threads, int iters, int kind) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  auto run = [&]() {
    if (kind == 0) mma_ceiling_kernel<false><<<blocks, threads>>>(out, iters, 1e-3f);
    else if (kind == 1) mma_ceiling_kernel<true><<<blocks, threads>>>(out, iters, 1e-3f);
    else wgmma_ceiling_kernel<<<blocks, threads>>>(out, iters, 1e-3f);
  };
  run();
  cudaEventRecord(a);
  run();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tf32_ceiling: no CUDA card", file=sys.stderr)
        return 1
    from gesturediffusion_tpu_torch.ops import _build

    build_dir = os.path.join(HERE, "build", "kernels")
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "tf32_ceiling.cu")
    lib = os.path.join(build_dir, "libtf32_ceiling.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).gdt_tf32_ceiling
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_float
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for kind, what in ((0, "mma.sync m16n8k8 without the operand split"),
                       (1, "mma.sync m16n8k8 with the operand split"),
                       (2, "wgmma m64n64k8, A from registers, the GEMM's stage")):
        for warps_per_sm in (4, 8, 16):
            blocks, threads = sms * warps_per_sm // 4, 128
            out = torch.empty(blocks * threads, device="cuda")
            ms = fn(out.data_ptr(), blocks, threads, iters, kind)
            if ms <= 0:
                raise RuntimeError("the ceiling kernel failed")
            # per warp: 8 chains x 3 m16n8k8; per warpgroup: 12 m64n64k8
            per_iter = 8 * 3 * 2 * 16 * 8 * 8 * (threads // 32) if kind < 2 else 12 * 2 * 64 * 64 * 8
            tf = blocks * iters * per_iter / ms / 1e9
            print(f"{what}, {warps_per_sm} warps/SM: {tf:.1f} TFLOP/s TF32 = {tf / 3:.1f} "
                  f"TFLOP/s f32-equivalent in 3 passes ({ms:.3f} ms) [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
