#!/usr/bin/env python3
"""The attention kernels past a head width of 128, case by case, on one card.

    python3 tools/wide_profile.py [--tree TREE] [CASE ...]

Runs the port found in TREE (default: this checkout; a parent unpacked
with ``git archive`` under build/ measures the tree before a change: one
process a tree, so two trees are timed in turns by running this twice
each).  The cases (default: every one but phase8):

  flash:DH  the flash forward (kernel 4) at [82, 4, 1201, DH]
  band:DH   the band (kernel 3) at [82, 8, 1200, DH], q = k = v the
            transposed view of [82, 1200, 8, DH] (the local block's
            heads), window 10
  local:D   the local block (kernel 2) at [82, 80, D], 8 local heads,
            window 10
  bwd:D     kernel 6 at [64, 81, D] (4 heads, ff 1024, rate 0.1), its
            attention backward by pass (D's row dot products, dQ, dK/dV)
  phase8    the tree's own chip_smoke.py phase 8 (the --latent_dim 320
            and 1024 steps, the generate CLI, wide_times), its wall time

Each call is timed by CUDA events over back-to-back calls, and one run of
calls is profiled (chip_smoke.py's device_split): the device time of a
call in all and by kernel name.  Beside them: the plain twin's time, the
library's (F.scaled_dot_product_attention; for the band under a boolean
band mask, for the local block composed around it, for kernel 6 its
autograd backward alone and the SDPA layer's forward + backward) and the
bound (chip_smoke.py's bound_ms: the inputs read once and the outputs
written once over 3.35 TB/s against the operations over the peak rate).
Before the cases, each kernel the cases run: its registers and spills
from the tree's ptxas report and its SASS instructions (cuobjdump).  Every
line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("flash:136", "flash:256", "flash:272", "flash:520", "band:136", "band:264",
         "local:1088", "local:2112", "bwd:1024", "bwd:2080")
# the library and the kernels (by name) each kind of case runs
LIBS = {"flash": ("flash_attention", "flash_fwd_wide_kernel"),
        "band": ("band_attention", "band_wide_kernel"),
        "local": ("local_block", "local_block_wide_kernel"),
        "bwd": ("encoder_layer_train", "attn_bwd_")}


def load(name: str, path: str):
    """The module at ``path`` under ``name`` (chip_smoke.py of this
    checkout or of the tree)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_reports(cs, kinds, card):
    """Registers and spills (ptxas) and SASS instructions of the kernels
    of ``kinds``, as the tree builds them."""
    from gesturediffusion_tpu_torch.ops import _build

    libs = sorted({LIBS[k][0] for k in kinds})
    reports = _build.build(libs)
    for lib in libs:
        kernels = [name for k, (lb, name) in LIBS.items() if lb == lib and k in kinds]
        sass = cs.tensor_core_sass(lib)
        entry = None
        for line in reports[lib].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                entry = name if "wide" in name and any(k in name for k in kernels) else None
                spill = None
            elif entry and "spill" in line and spill is None:
                spill = line.strip()
            elif entry and "registers" in line:
                base = next(re.search(f"([a-z_]*{k}[a-z_]*)(?:I(\\w+?)EEv)?", entry)
                            for k in kernels if k in entry)
                args = ",".join(re.findall(r"L[bi](\d+)E", (base.group(2) or "") + "E"))
                regs = re.search(r"Used (\d+) registers", line).group(1)
                ops = sass.get(entry, {})
                print(f"{lib} {base.group(1)}<{args}>: {regs} registers, {spill}; SASS "
                      f"{ops.get('all', 'not measured')} instructions {card}", flush=True)
                entry = None


def line(cs, what, call_ms, device, names, plain_ms, lib_ms, err, flops, nbytes, card,
         tf32x3=False):
    bound, by = cs.bound_ms(flops, nbytes, tf32x3)
    print(f"{what}: call {call_ms:.4f} ms (CUDA events), device {device:.4f} ms, "
          f"{bound / device:.3f} of the bound {bound:.4f} ms ({by}; {nbytes / 1e6:.3f} MB, "
          f"{flops / 1e9:.4f} GFLOP); plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms; "
          f"max|diff| against plain {err:.3e} {card}", flush=True)
    for name, (ms, n) in sorted(names.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:.4f} ms x{n:g}  {name[:150]}", flush=True)


def flash_case(cs, randn, dh, card):
    import torch

    from gesturediffusion_tpu_torch.ops.flash_attention import (
        fused_self_attention,
        self_attention_reference,
    )

    b, h, t = 2 * cs.B_TAKES, cs.HEADS, cs.T_LONG + 1
    q, k, v = (randn(b, h, t, dh) for _ in range(3))

    def call():
        return fused_self_attention(q, k, v)

    err = (call() - self_attention_reference(q, k, v)).abs().max().item()
    call_ms = cs.cuda_time_ms(call, 10, 2)
    device, names = cs.device_split(call, 10, want=LIBS["flash"][1])
    plain_ms = cs.cuda_time_ms(lambda: self_attention_reference(q, k, v), 3, 1)
    lib_ms = cs.cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10, 2)
    line(cs, f"flash [{b},{h},{t},{dh}]", call_ms, device, names, plain_ms, lib_ms, err,
         4 * b * h * t * t * dh, 4 * 4 * q.numel(), card, tf32x3=True)


def band_case(cs, randn, dh, card):
    from gesturediffusion_tpu_torch.ops.band_attention import local_attention_band
    from gesturediffusion_tpu_torch.ops.local_attention import local_attention

    b, h, t, w = 2 * cs.B_TAKES, cs.CL_HEADS, cs.T_LONG, cs.WINDOW
    q = randn(b, t, h, dh).transpose(1, 2)

    def call():
        return local_attention_band(q, q, q, window_size=w)

    err = (call() - local_attention(q, q, q, window_size=w)).abs().max().item()
    call_ms = cs.cuda_time_ms(call, 10, 2)
    device, names = cs.device_split(call, 20, want="band_")
    plain_ms = cs.cuda_time_ms(lambda: local_attention(q, q, q, window_size=w), 3, 1)
    lib_ms = cs.cuda_time_ms(lambda: cs.band_sdpa(q, w), 3, 1)
    line(cs, f"band [{b},{h},{t},{dh}] w {w} (q = k = v strided)", call_ms, device, names,
         plain_ms, lib_ms, err, 4 * b * h * cs.band_keys(t, w) * dh, 4 * 2 * q.numel(), card)


def local_case(cs, randn, d, card):
    from gesturediffusion_tpu_torch.ops.fused_local_block import (
        fused_local_block,
        pre_encoder_local_block,
    )

    b, h, t, w = 2 * cs.B_TAKES, cs.CL_HEADS, cs.T, cs.WINDOW
    x, coa = randn(b, t, d), randn(b, d)

    def call():
        return fused_local_block(x, coa, num_heads=h, window=w)

    def plain():
        return pre_encoder_local_block(x, coa, num_heads=h, window_size=w)

    err = (call() - plain()).abs().max().item()
    call_ms = cs.cuda_time_ms(call, 20, 3)
    device, names = cs.device_split(call, 20, want="kernel")
    plain_ms = cs.cuda_time_ms(plain, 10, 2)
    lib_ms = cs.cuda_time_ms(lambda: cs.local_block_sdpa(x, coa, h, w), 10, 2)
    dh = d // h
    flops = b * h * cs.band_keys(t, w) * dh * 4 + 3 * b * (2 * t + 1) * d
    nbytes = 4 * (b * t * d + b * d + b * (t + 1) * d)
    line(cs, f"local block [{b},{t},{d}] {h} heads of {dh} w {w}", call_ms, device, names,
         plain_ms, lib_ms, err, flops, nbytes, card)


def bwd_case(cs, randn, d, card):
    import torch

    seed = torch.tensor([20240], dtype=torch.int32, device="cuda")
    b, t = cs.MB, cs.T + 1
    w = cs.layer_weights(randn, d, cs.FF)
    x, g = randn(b, t, d), randn(b, t, d)
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        split = cs.attention_backward_split(x, g, w, seed)
        sdpa_bwd = cs.sdpa_backward_ms(b, t, d // cs.HEADS)
        tw = [y.clone().requires_grad_() for y in w]
        tx = x.clone().requires_grad_()

        def sdpa_layer():
            with torch.enable_grad():
                cs.encoder_layer_sdpa(tx, *tw, cs.HEADS, rate=cs.RATE).backward(g)

        sdpa_layer_ms = cs.cuda_time_ms(sdpa_layer, iters=10, warmup=2)
    flops, nbytes, bound, by = cs.attention_backward_bound(b, t, d)
    t_bytes, t_ops = nbytes / cs.PEAK_BYTES_PER_S * 1e3, 3 * flops / cs.PEAK_TF32_FLOPS * 1e3
    parts = ", ".join(f"{k} {split[k]:.4f} ms x{split[k + ' launches']}"
                      for k, _ in cs.ATTN_BWD_KERNELS)
    print(f"kernel 6 [{b},{t},{d}] heads {cs.HEADS} of {d // cs.HEADS} ff {cs.FF} rate "
          f"{cs.RATE}: call {split['call']:.4f} ms (CUDA events), device {split['device']:.4f} "
          f"ms; attention backward {split['passes']:.4f} ms ({parts}), "
          f"{split['passes'] / split['device']:.3f} of the device time; its bound "
          f"{bound:.4f} ms ({by}; bytes {t_bytes:.4f}, operations {t_ops:.4f}), "
          f"{bound / split['passes']:.3f} of it; SDPA's backward alone {sdpa_bwd:.4f} ms; "
          f"the SDPA layer forward + backward {sdpa_layer_ms:.4f} ms {card}", flush=True)
    for name, ms in sorted(split["names"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:.4f} ms  {name}", flush=True)


def phase8(tree, card):
    """The tree's chip_smoke.py phase 8, as its main() runs it."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.ops import _build

    _build.build()
    smoke = load("tree_smoke", os.path.join(tree, "chip_smoke.py"))
    rs = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to("cuda")

    # the wall time of each part of wide_times that the tree has
    spans = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
        return run

    for name in ("wide_train_and_band_times", "wide_train_steps", "wide_bwd_rows",
                 "wide_local_steps"):
        if hasattr(smoke, name):
            setattr(smoke, name, timed(name, getattr(smoke, name)))
    root = os.path.join(tree, "build", "chip_smoke")
    t0 = time.perf_counter()
    smoke.c1_model_phase(randn, root, card)
    smoke.c1_model_phase(randn, root, card, d=smoke.D_WIDE, cli=False)
    mid = time.perf_counter()
    smoke.wide_times(randn, card)
    end = time.perf_counter()
    parts = ", ".join(f"{name} {t:.1f} s" for name, t in spans.items())
    print(f"phase 8 of {tree}: {end - t0:.1f} s (the --latent_dim steps and CLI "
          f"{mid - t0:.1f} s, wide_times {end - mid:.1f} s: {parts}) {card}", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)  # the port under test; chip_smoke.py's helpers from this checkout
    import numpy as np
    import torch

    cs = load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    if not torch.cuda.is_available():
        print("wide_profile: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    card = f"[{smi}]"
    import gesturediffusion_tpu_torch as pkg

    print(f"wide_profile: the port at {os.path.dirname(pkg.__file__)} {card}", flush=True)
    kinds = [c.split(":")[0] for c in args.cases]
    kernel_reports(cs, [k for k in kinds if k in LIBS], card)
    own = np.random.RandomState(25)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(own.randn(*shape).astype(np.float32) * scale).to("cuda")

    run = {"flash": flash_case, "band": band_case, "local": local_case, "bwd": bwd_case}
    for case in args.cases:
        if case == "phase8":
            phase8(tree, card)
            continue
        kind, size = case.split(":")
        run[kind](cs, randn, int(size), card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
