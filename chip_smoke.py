#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gesturediffusion_tpu_torch) on one
NVIDIA card: ``python3 chip_smoke.py`` from the root of the repository.

Phases, each fatal on failure:
  1. device   card name, count, power limit; TF32 switched off
  2. build    nvcc builds every kernel from csrc/ (in parallel), printing
              the -Xptxas -v register / shared-memory / spill lines
  3. parity   each kernel against its plain PyTorch version on the card at
              the main-path shapes, with the tolerance stated
  4. main     the full-width gesture MDM V2 (J=498, D=256, 8 layers) with
              seeded random weights samples a 41-take, 2-chunk CFG take
              (batch 82) through select_sampling_model_fn ->
              autoregressive_sample_loop, counting kernel launches; the same
              take re-runs with the plain versions on the card and the two
              are compared; then the generate CLI runs on a checkpoint
              written here
  5. times    kernel, plain and library-call times (CUDA events), take
              throughput and peak memory, with the card name and power limit
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
B_TAKES, J, T, D, S, A = 41, 498, 80, 256, 10, 26
LAYERS, HEADS, FF, CL_HEADS, WINDOW = 8, 4, 1024, 8, 10
CHUNKS, RESPACING, STEPS, GUIDANCE = 2, "50", 50, 2.5
TOL_LOCAL_BLOCK = 1e-4   # f32; <= 20-term softmax sums, cos/sin within 2 ulp
TOL_ENCODER = 5e-4       # f32; K<=1024 sums in another order, LN rescaling
TOL_TAKE = 1e-3          # f32; 100 chained denoise steps of 8 layers each


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def local_block_sdpa(xseq, coa, num_heads, window):
    """Yardstick: the local block composed from torch ops with
    F.scaled_dot_product_attention and a boolean band mask."""
    import torch
    import torch.nn.functional as F

    from gesturediffusion_tpu_torch.models.embeddings import apply_rotary_pos_emb, rotary_freqs

    b, t, d = xseq.shape
    dh = d // num_heads
    h = xseq.reshape(b, t, num_heads, dh).transpose(1, 2)
    h, _ = apply_rotary_pos_emb(h, h, rotary_freqs(t, dh, xseq.device))
    i = torch.arange(t, device=xseq.device)
    wi = i // window
    allowed = (i[None, :] <= i[:, None]) & (wi[:, None] - wi[None, :] <= 1)
    h = F.scaled_dot_product_attention(h, h, h, attn_mask=allowed)
    y = torch.cat([coa[:, None], h.transpose(1, 2).reshape(b, t, d)], dim=1)
    h = y.reshape(b, t + 1, num_heads, dh).transpose(1, 2)
    h, _ = apply_rotary_pos_emb(h, h, rotary_freqs(t + 1, dh, xseq.device))
    return h.transpose(1, 2).reshape(b, t + 1, d)


def encoder_layer_sdpa(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, num_heads):
    """Yardstick: the encoder layer composed from torch ops with
    F.scaled_dot_product_attention."""
    import torch.nn.functional as F

    b, t, d = x.shape
    q, k, v = (y.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)
               for y in F.linear(x, wqkv, bqkv).chunk(3, dim=-1))
    a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, d)
    x = F.layer_norm(x + F.linear(a, wo, bo), (d,), l1w, l1b, 1e-5)
    h = F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2)
    return F.layer_norm(x + h, (d,), l2w, l2b, 1e-5)


def profile_denoise_step(model, diffusion, chunk_conds, init_seed, card, steps=10):
    """Device time by kernel over ``steps`` CFG denoise steps (torch.profiler,
    CUPTI), and the device's idle share of an unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn

    precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
    cond = precompute({"mfcc": chunk_conds["mfcc"][0], "scale": chunk_conds["scale"][0],
                       "seed": init_seed})
    x = torch.zeros((B_TAKES, J, 1, T), device=init_seed.device)
    noise = torch.randn_like(x)
    t = torch.full((B_TAKES,), STEPS // 2, dtype=torch.long, device=x.device)

    def step():
        p_sample(diffusion, model_fn, x, t, cond, noise)

    step_ms = cuda_time_ms(step, iters=steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue  # an op's row repeats the time of the kernels it launched
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / steps / 1e3, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile: denoise step {step_ms:.4f} ms (CUDA events, unprofiled); kernels "
        f"{busy_ms:.4f} ms/step on the device -> idle share "
        f"{max(0.0, 1 - busy_ms / step_ms):.3f} {card}")
    for ms, n, name in rows[:12]:
        log(f"  {ms:.4f} ms/step {100 * ms / busy_ms:5.1f}%  x{n}  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
    from gesturediffusion_tpu_torch.ops import _build
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.fused_local_block import (
        fused_local_block,
        pre_encoder_local_block,
    )

    # ---- 1. device ----------------------------------------------------- #
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)  # name, power limit as nvidia-smi prints them
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = f"[{smi}]"
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------ #
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                log(f"  {name}: {line.strip()}")

    torch.set_grad_enabled(False)
    rs = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(dev)

    # ---- 3. kernel parity at the main-path shapes ---------------------- #
    bb = 2 * B_TAKES
    xs, coa = randn(bb, T, D), randn(bb, D)
    lb_plain = pre_encoder_local_block(xs, coa, num_heads=CL_HEADS, window_size=WINDOW)
    lb_kernel = fused_local_block(xs, coa, num_heads=CL_HEADS, window=WINDOW)
    torch.cuda.synchronize()
    lb_err = (lb_kernel - lb_plain).abs().max().item()
    ok = lb_kernel.shape == (bb, T + 1, D) and lb_err <= TOL_LOCAL_BLOCK
    log(f"{'OK' if ok else 'FAIL'} local_block [{bb},{T},{D}]->[{bb},{T + 1},{D}] "
        f"heads {CL_HEADS} w {WINDOW}: max|diff| {lb_err:.3e} (tol {TOL_LOCAL_BLOCK:g})")
    if not ok:
        raise AssertionError("local_block kernel disagrees with its plain version")

    xe = randn(bb, T + 1, D)
    enc_w = (
        randn(3 * D, D, scale=D**-0.5), randn(3 * D, scale=0.02),
        randn(D, D, scale=D**-0.5), randn(D, scale=0.02),
        1.0 + randn(D, scale=0.1), randn(D, scale=0.1),
        randn(FF, D, scale=D**-0.5), randn(FF, scale=0.02),
        randn(D, FF, scale=FF**-0.5), randn(D, scale=0.02),
        1.0 + randn(D, scale=0.1), randn(D, scale=0.1),
    )
    enc_plain = encoder_layer_plain(xe, *enc_w, num_heads=HEADS)
    enc_kernel = fused_encoder_layer(xe, *enc_w, num_heads=HEADS)
    torch.cuda.synchronize()
    enc_err = (enc_kernel - enc_plain).abs().max().item()
    ok = enc_kernel.shape == xe.shape and enc_err <= TOL_ENCODER
    log(f"{'OK' if ok else 'FAIL'} encoder_layer [{bb},{T + 1},{D}] heads {HEADS} ff {FF}: "
        f"max|diff| {enc_err:.3e} (tol {TOL_ENCODER:g})")
    if not ok:
        raise AssertionError("encoder_layer kernel disagrees with its plain version")

    # ---- 4. main path: full-width CFG chunked-AR take ------------------ #
    torch.manual_seed(0)
    model = MDM(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS,
                num_heads=HEADS, cond_mask_prob=0.1, seed_poses=S, mfcc_dim=A,
                cl_head=CL_HEADS, window_size=WINDOW).to(dev).eval()
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=RESPACING, device=dev)
    assert diffusion.num_timesteps == STEPS
    chunk_conds = {
        "mfcc": randn(CHUNKS, B_TAKES, A, 1, T),
        "scale": torch.full((CHUNKS, B_TAKES), GUIDANCE, device=dev),
    }
    init_seed = randn(B_TAKES, J, 1, S, scale=0.5)
    shape = (B_TAKES, J, 1, T)

    def take(seed: int) -> torch.Tensor:
        precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = autoregressive_sample_loop(
            diffusion, model_fn, shape, chunk_conds, init_seed, S,
            generator=gen, cond_precompute=precompute,
        )
        torch.cuda.synchronize()
        return out

    fused_local_block.launches = 0
    fused_encoder_layer.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = take(1)
    first_s = time.perf_counter() - t0
    launches = {"local_block": fused_local_block.launches,
                "encoder_layer": fused_encoder_layer.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {"local_block": STEPS * CHUNKS, "encoder_layer": STEPS * CHUNKS * LAYERS}
    log(f"take: out {tuple(out.shape)} finite={bool(torch.isfinite(out).all())} "
        f"launches {launches} (expected {want}); first run {first_s:.3f} s")
    if tuple(out.shape) != (CHUNKS, B_TAKES, J, 1, T) or not torch.isfinite(out).all():
        raise AssertionError("take output has the wrong shape or non-finite values")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")

    t0 = time.perf_counter()
    take(1)
    kernel_take_s = time.perf_counter() - t0
    model.use_kernels = False
    t0 = time.perf_counter()
    out_plain = take(1)
    plain_take_s = time.perf_counter() - t0
    model.use_kernels = True
    take_err = (out - out_plain).abs().max().item()
    ok = take_err <= TOL_TAKE
    log(f"{'OK' if ok else 'FAIL'} take vs plain versions on the card: max|diff| "
        f"{take_err:.3e} (tol {TOL_TAKE:g}; |out| max {out_plain.abs().max().item():.3f})")
    if not ok:
        raise AssertionError("kernel take disagrees with the plain take")

    ckpt_dir = os.path.join(HERE, "build", "chip_smoke", "run")
    os.makedirs(ckpt_dir, exist_ok=True)
    model_path = os.path.join(ckpt_dir, "model000000000.pt")
    torch.save(model.state_dict(), model_path)
    with open(os.path.join(ckpt_dir, "args.json"), "w") as f:
        json.dump({"dataset": "synthetic", "num_frames": T, "layers": LAYERS,
                   "latent_dim": D, "cond_mask_prob": 0.1, "seed_poses": S,
                   "noise_schedule": "cosine", "diffusion_steps": 1000,
                   "sigma_small": True}, f)
    out_dir = os.path.join(ckpt_dir, "samples")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "gesturediffusion_tpu_torch.sample.generate",
         "--model_path", model_path, "--dataset", "synthetic",
         "--num_samples", str(B_TAKES), "--timestep_respacing", RESPACING,
         "--guidance_param", str(GUIDANCE), "--output_dir", out_dir],
        check=True, cwd=HERE, timeout=600,
    )
    res = np.load(os.path.join(out_dir, "results.npy"), allow_pickle=True).item()
    cli_ok = res["motion"].shape == (B_TAKES, J // 6, 3, T) and np.isfinite(res["motion"]).all()
    log(f"{'OK' if cli_ok else 'FAIL'} generate CLI on the card: motion "
        f"{res['motion'].shape} in {time.perf_counter() - t0:.1f} s (process included)")
    if not cli_ok:
        raise AssertionError("generate CLI output has the wrong shape or non-finite values")

    # ---- 5. times ------------------------------------------------------ #
    lb_ms = cuda_time_ms(lambda: fused_local_block(xs, coa, num_heads=CL_HEADS, window=WINDOW))
    lb_plain_ms = cuda_time_ms(
        lambda: pre_encoder_local_block(xs, coa, num_heads=CL_HEADS, window_size=WINDOW))
    lb_lib_ms = cuda_time_ms(lambda: local_block_sdpa(xs, coa, CL_HEADS, WINDOW))
    dh = D // CL_HEADS
    keys = sum(i - max(0, (i // WINDOW - 1) * WINDOW) + 1 for i in range(T))
    lb_flops = bb * CL_HEADS * keys * dh * 4 + 3 * bb * (2 * T + 1) * D
    lb_bytes = 4 * (bb * T * D + bb * D + bb * (T + 1) * D)
    lb_bound, lb_by = bound_ms(lb_flops, lb_bytes)

    enc_ms = cuda_time_ms(lambda: fused_encoder_layer(xe, *enc_w, num_heads=HEADS))
    enc_plain_ms = cuda_time_ms(lambda: encoder_layer_plain(xe, *enc_w, num_heads=HEADS))
    enc_lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(xe, *enc_w, HEADS))
    m = bb * (T + 1)
    enc_flops = 2 * m * (4 * D * D + 2 * D * FF) + 4 * bb * (T + 1) ** 2 * D
    enc_bytes = 4 * (2 * m * D + sum(w.numel() for w in enc_w))
    enc_bound, enc_by = bound_ms(enc_flops, enc_bytes)

    for name, ms, pms, lms, bnd, by, fl, nb in (
        ("local_block", lb_ms, lb_plain_ms, lb_lib_ms, lb_bound, lb_by, lb_flops, lb_bytes),
        ("encoder_layer", enc_ms, enc_plain_ms, enc_lib_ms, enc_bound, enc_by, enc_flops, enc_bytes),
    ):
        log(f"time {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, torch+SDPA {lms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; {fl / 1e9:.4f} GFLOP, {nb / 1e6:.3f} MB) {card}")
    n_steps = STEPS * CHUNKS
    log(f"time take ({B_TAKES} takes x {CHUNKS} chunks x {STEPS} DDPM steps, CFG batch {bb}): "
        f"kernels {kernel_take_s:.3f} s = {B_TAKES * CHUNKS / kernel_take_s:.3f} chunks/s, "
        f"{kernel_take_s / n_steps * 1e3:.3f} ms/step; plain {plain_take_s:.3f} s = "
        f"{B_TAKES * CHUNKS / plain_take_s:.3f} chunks/s, "
        f"{plain_take_s / n_steps * 1e3:.3f} ms/step {card}")
    log(f"peak memory (counted take): {peak_mib:.1f} MiB {card}")
    profile_denoise_step(model, diffusion, chunk_conds, init_seed, card)

    kernels = [
        {"name": "local_block", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/local_block.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_local_block.py:82",
         "launches": launches["local_block"], "max_abs_err": lb_err,
         "ms": lb_ms, "plain_ms": lb_plain_ms, "bound_ms": lb_bound,
         "bound_by": lb_by, "library_ms": lb_lib_ms},
        {"name": "encoder_layer", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/encoder_layer.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_encoder.py:98",
         "launches": launches["encoder_layer"], "max_abs_err": enc_err,
         "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
         "bound_by": enc_by, "library_ms": enc_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
