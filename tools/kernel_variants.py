#!/usr/bin/env python3
"""The shipped 3xTF32 kernels against patched copies of themselves, on one card.

    python3 tools/kernel_variants.py

Each variant is a copy of gesturediffusion_tpu_torch/csrc/ under
build/variants/<name>/ with a few source lines replaced (VARIANTS below),
built with the port's nvcc flags; its C entry points are called through
ctypes, in turns with the shipped build, on the same inputs:

  cvt_rounding       TF32 rounding by cvt.rna.tf32.f32 instead of the two
                     integer operations of tf32_rn (the same rounding)
  gemm_no_loads      the GEMM without its global loads (shared memory keeps
                     stale data)
  gemm_no_split      the GEMM's W split pass without its shared-memory
                     reads, its proxy fence and its barrier (the rounding
                     and the stores stay)
  gemm_no_a_frags    the GEMM without its A fragment reads
  gemm_wgmma_only    the GEMM with all three removed: wgmma, the epilogue
                     and the stage's barriers are left

The gemm_no_* variants compute wrong numbers: they are ablations, timed to
see what each phase of a stage costs, and their errors are not checked.
One line a case: the encoder layer at [82, 81, 256] and [82, 1201, 256]
(ff 1024, 4 heads; its products' device time from the profiler at 1201 rows)
and the flash kernel at [82, 4, 1201, 64], with the card's name and power
limit.  A patch that no longer matches the sources fails loudly.
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

G = "gemm_tf32x3.cuh"
VARIANTS = {
    "cvt_rounding": [(G, "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                      "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
                      "  return r;")],
    "gemm_no_loads": [(G, "    if (next < ktiles) load_stage(next % kTcStages, next);", ""),
                      (G, "    if (s < ktiles) load_stage(s, s);", "")],
    "gemm_no_split": [(G, "    fence_proxy_async();\n    __syncthreads();\n", ""),
                      (G, "        const float4 lo = ld4(bs), hi = ld4(bs + 4);",
                       "        const float4 lo = make_float4(1.f, 2.f, 3.f, 4.f), hi = lo;")],
    "gemm_no_a_frags": [(G, "        lo = *reinterpret_cast<const float2*>(as + arow * kTcLd + 8 * s + 2 * t);\n"
                            "        hi = *reinterpret_cast<const float2*>(as + (arow + 8) * kTcLd + 8 * s"
                            " + 2 * t);",
                         "        lo = make_float2(s, 1.f);\n        hi = lo;")],
}
VARIANTS["gemm_wgmma_only"] = (VARIANTS["gemm_no_loads"] + VARIANTS["gemm_no_split"]
                               + VARIANTS["gemm_no_a_frags"])


def build(name: str, patches) -> dict[str, ctypes.CDLL]:
    from gesturediffusion_tpu_torch.ops import _build

    src = _build.CSRC_DIR
    if patches is not None:
        src = os.path.join(HERE, "build", "variants", name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, src)
        for fname, old, new in patches:
            path = os.path.join(src, fname)
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"variant {name}: {fname} no longer holds {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
    out = os.path.join(HERE, "build", "variants", name + "-lib")
    os.makedirs(out, exist_ok=True)
    procs = {k: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                  os.path.join(out, f"lib{k}.so"), os.path.join(src, k + ".cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in ("encoder_layer", "flash_attention")}
    libs = {}
    for k, p in procs.items():
        report, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {k}.cu\n{report}")
        libs[k] = ctypes.CDLL(os.path.join(out, f"lib{k}.so"))
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    from gesturediffusion_tpu_torch.ops.flash_attention import self_attention_reference
    from gesturediffusion_tpu_torch.ops.fused_encoder import encoder_layer_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    builds = {"shipped": build("shipped", None)}
    builds.update({name: build(name, patches) for name, patches in VARIANTS.items()})
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

    d, ff, heads = 256, 1024, 4
    w = (rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.02), rn(d, d, scale=d**-0.5),
         rn(d, scale=0.02), 1 + rn(d, scale=0.1), rn(d, scale=0.1), rn(ff, d, scale=d**-0.5),
         rn(ff, scale=0.02), rn(d, ff, scale=ff**-0.5), rn(d, scale=0.02), 1 + rn(d, scale=0.1),
         rn(d, scale=0.1))

    def layer(lib, x):
        fn = lib.gdt_encoder_layer_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 19 + [i] * 5 + [ctypes.c_float, i, p]
        b, t, _ = x.shape
        new = functools.partial(torch.empty, device="cuda")
        bufs = (new(b * t, 3 * d), new(b * t, d), new(b * t, d), new(b * t, d), new(b * t, ff))
        out = new(b, t, d)
        code = fn(x.data_ptr(), *(y.data_ptr() for y in w), *(y.data_ptr() for y in bufs),
                  out.data_ptr(), b, t, d, ff, heads, (d // heads) ** -0.5, 1,
                  torch.cuda.current_stream().cuda_stream)
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

    def gemm_ms(lib, x):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                layer(lib, x)
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if "gemm_tf32x3_kernel" in e.key and e.device_type != torch.autograd.DeviceType.CPU:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
        return us / 5 / 1e3

    for t in (81, 1201):
        x = rn(82, t, d)
        want = encoder_layer_plain(x, *w, num_heads=heads)
        parts = []
        for name, libs in builds.items():
            err = (layer(libs["encoder_layer"], x) - want).abs().max().item()
            ms = cuda_ms(lambda: layer(libs["encoder_layer"], x))
            note = f"{err:.2e}" if not name.startswith("gemm_") else "not checked"
            extra = f", products {gemm_ms(libs['encoder_layer'], x):.4f} ms" if t > 81 else ""
            parts.append(f"{name} {ms:.4f} ms (max|diff| {note}{extra})")
        print(f"encoder layer [82,{t},{d}]: " + "; ".join(parts) + f" [{smi}]", flush=True)

    q, k, v = (rn(82, heads, 1201, d // heads) for _ in range(3))
    want = self_attention_reference(q, k, v)
    parts = []
    for name in ("shipped", "cvt_rounding"):
        lib = builds[name]["flash_attention"]
        err = (flash(lib, q, k, v) - want).abs().max().item()
        parts.append(f"{name} {cuda_ms(lambda: flash(lib, q, k, v)):.4f} ms (max|diff| {err:.2e})")
    print(f"flash [82,{heads},1201,{d // heads}]: " + "; ".join(parts) + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
