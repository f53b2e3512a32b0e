#!/usr/bin/env python3
"""Sampling and training speed of several trees of the PyTorch port on one
card, in turns.

    python3 tools/take_ab.py build/parent . . build/parent

For each tree given (the root of a checkout: a `git archive` of another
commit unpacked into a git-ignored directory, or `.`), a process of its own
imports that tree's gesturediffusion_tpu_torch (its kernels built from its
csrc/ into its build/kernels/) and times, with the kernels, the two
sampling takes of chip_smoke.py (this tree's copy supplies the constants
and the take driver): the 80-frame take (41 takes x 2 chunks x 50 DDPM
steps, CFG batch 82) and the 1200-frame take (41 x 2 x 20 steps), each run
once to warm up and then timed three times, then the full-width train step
of chip_smoke.py's phase 5 (batch 256 = 4 x 64 at 80 frames, dropout 0.1,
the fused training layer, injected timesteps and noise), run six times,
with the same seeded weights and inputs in every tree, then a
text-to-motion denoise step of phase 10's model at CFG batch 6 and 64
(three runs of 20 steps by CUDA events; the CFG-6 step's idle share: one
less the profiler's device time over the step's time), kernel 1's host
time a call at [6, 197, 512] and [82, 81, 256] (the wall time of 50
back-to-back calls with nothing synchronised, over 50), then the training
layer's forward and backward kernels (5 and 6) alone at the three training
shapes of the smoke run, [64, 81, 256], [64, 197, 512] and [64, 61, 512]
(CUDA events over 20 calls, median of three), then the text-to-motion
train step of phase 12 (humanml-encoder-512 at batch 64, 196 frames) and
the action-to-motion train step of phase 13 (the action MotionMDM at batch
64, 60 frames, the recipe's geometric losses through a synthetic SMPL of
6890 vertices written under the tree's build/), six each.  One line a
tree: the median ms per denoise step and chunks/s of each take, the median
ms, samples/s and peak memory of train steps 2-6 (gesture, t2m, a2m), the median t2m
step, kernel 1's host ms and the kernels' ms, with the card's name and
power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_tree(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.models.mdm import MDM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = MDM(njoints=cs.J, latent_dim=cs.D, ff_size=cs.FF, num_layers=cs.LAYERS,
                num_heads=cs.HEADS, cond_mask_prob=0.1, seed_poses=cs.S, mfcc_dim=cs.A,
                cl_head=cs.CL_HEADS, window_size=cs.WINDOW).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    init_seed = torch.randn(cs.B_TAKES, cs.J, 1, cs.S, generator=gen, device=dev) * 0.5
    result = {"root": root}
    for frames, respacing, steps in ((cs.T, cs.RESPACING, cs.STEPS),
                                     (cs.T_LONG, cs.LONG_RESPACING, cs.LONG_STEPS)):
        diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                     timestep_respacing=respacing, device=dev)
        conds = {"mfcc": torch.randn(cs.CHUNKS, cs.B_TAKES, cs.A, 1, frames, generator=gen,
                                     device=dev),
                 "scale": torch.full((cs.CHUNKS, cs.B_TAKES), cs.GUIDANCE, device=dev)}
        cs.run_take(model, diffusion, conds, init_seed, 1)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            cs.run_take(model, diffusion, conds, init_seed, 1)
            times.append(time.perf_counter() - t0)
        take_s = sorted(times)[1]
        result[f"T={frames}"] = {"ms_per_step": take_s / (steps * cs.CHUNKS) * 1e3,
                                 "chunks_per_s": cs.B_TAKES * cs.CHUNKS / take_s}
    ms, peak = train_step_ms(cs, gen)
    result["train"] = {"ms": ms, "samples_per_s": cs.BATCH / ms * 1e3, "peak_mib": peak}
    for name in ("t2m train", "a2m train"):
        ms, peak = motion_train_step_ms(cs, gen, root, action=name.startswith("a2m"))
        result[name] = {"ms": ms, "samples_per_s": cs.MB / ms * 1e3, "peak_mib": peak}
    result["t2m"] = t2m_step_ms(cs, gen)
    result["layer_host"] = layer_host_ms(cs, gen)
    result["train_kernels"] = train_kernel_ms(cs, gen)
    return result


def train_kernel_ms(cs, gen) -> dict:
    """Median ms of the training forward and backward kernels (rate 0.1)
    at [64, 81, 256], [64, 197, 512] and [64, 61, 512], ff 1024."""
    import torch

    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )

    dev = torch.device("cuda")
    seed = torch.tensor([20241], dtype=torch.int32, device=dev)
    out = {}
    for t, d in ((cs.T + 1, cs.D), (cs.T2M_FRAMES + 1, cs.T2M_D), (cs.A2M_FRAMES + 1, cs.T2M_D)):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * scale

        w = cs.layer_weights(rn, d, cs.FF)
        x, g = rn(cs.MB, t, d), rn(cs.MB, t, d)
        kw = dict(seed=seed, num_heads=cs.HEADS, rate=cs.RATE)
        for name, fn in (("fwd", lambda: encoder_layer_train_fwd(x, *w, **kw)),
                         ("bwd", lambda: encoder_layer_train_bwd(x, *w, g=g, **kw))):
            runs = [cs.cuda_time_ms(fn, 20, 3) for _ in range(3)]
            out[f"{name} [{cs.MB},{t},{d}]"] = sorted(runs)[1]
    return out


def layer_host_ms(cs, gen) -> dict:
    """Kernel 1's host time a call: 50 back-to-back calls, nothing
    synchronised inside the window, after a warm up."""
    import torch

    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer

    dev = torch.device("cuda")
    out = {}
    for b, t, d in ((cs.T2M_REPS * 2, cs.T2M_FRAMES + 1, cs.T2M_D), (2 * cs.B_TAKES, cs.T + 1, cs.D)):
        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * scale

        w, x = cs.layer_weights(rn, d, cs.FF), rn(b, t, d)
        for _ in range(5):
            fused_encoder_layer(x, *w, num_heads=cs.HEADS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fused_encoder_layer(x, *w, num_heads=cs.HEADS)
        out[f"[{b},{t},{d}]"] = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
    return out


def t2m_step_ms(cs, gen) -> dict:
    """Median ms of a text-to-motion denoise step (chip_smoke.py's phase-10
    model, CFG batch 6 and 64, through the kernels) over three runs of 20."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample
    from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    torch.manual_seed(4)
    model = MotionMDM(njoints=cs.T2M_J, latent_dim=cs.T2M_D, ff_size=cs.FF,
                      num_layers=cs.LAYERS, num_heads=cs.HEADS, cond_mode="text",
                      cond_mask_prob=0.1).to(dev).eval()
    guided = classifier_free_guidance(model, 0.1)
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=cs.T2M_RESPACING, device=dev)
    out = {}
    for b in (cs.T2M_REPS, cs.T2M_BIG):
        shape = (b, cs.T2M_J, 1, cs.T2M_FRAMES)
        x = torch.randn(shape, generator=gen, device=dev)
        noise = torch.randn(shape, generator=gen, device=dev)
        cond = {"text_emb": torch.randn(b, 512, generator=gen, device=dev) * 0.1,
                "scale": torch.full((b,), cs.GUIDANCE, device=dev)}
        t = torch.full((b,), diffusion.num_timesteps // 2, dtype=torch.long, device=dev)
        def step():
            return p_sample(diffusion, guided, x, t, cond, noise)

        runs = [cs.cuda_time_ms(step, 20, 3) for _ in range(3)]
        out[f"CFG {2 * b}"] = sorted(runs)[1]
        if b == cs.T2M_REPS:
            out[f"CFG {2 * b} idle share"] = 1.0 - cs.device_split(step, 10)[0] / out[f"CFG {2 * b}"]
    return out


def train_step_ms(cs, gen) -> tuple[float, float]:
    """Median ms of train steps 2-6 at chip_smoke.py's phase-5 shape, and
    the peak MiB allocated over the six."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.train.loop import (
        TrainConfig,
        TrainState,
        make_optimizer,
        train_step,
    )

    torch.set_grad_enabled(True)
    dev = torch.device("cuda")
    torch.manual_seed(1)
    model = MDM(njoints=cs.J, latent_dim=cs.D, ff_size=cs.FF, num_layers=cs.LAYERS,
                num_heads=cs.HEADS, dropout=cs.RATE, cond_mask_prob=0.1, seed_poses=cs.S,
                mfcc_dim=cs.A, cl_head=cs.CL_HEADS, window_size=cs.WINDOW,
                use_fused_train_encoder=True).to(dev)
    cfg = TrainConfig(lr=1e-4, batch_size=cs.BATCH, microbatch_size=cs.MB)
    state = TrainState(model, *make_optimizer(model.parameters(), cfg), UniformSampler(1000), {})
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    n, t = cs.BATCH, cs.T
    motion, noise = rn(n, cs.J, 1, t) * 0.5, rn(n, cs.J, 1, t)
    cond = {"mfcc": rn(n, cs.A, 1, t), "seed": rn(n, cs.J, 1, cs.S) * 0.5,
            "mask": torch.ones((n, 1, 1, t), dtype=torch.bool, device=dev)}
    steps = torch.randint(0, 1000, (n,), generator=gen, device=dev)
    step_gen = torch.Generator(device=dev).manual_seed(7)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, diffusion, cfg, motion, cond, step_gen, steps, noise)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times[1:])[2] * 1e3, torch.cuda.max_memory_allocated() / 2**20


def motion_train_step_ms(cs, gen, root, action=False) -> tuple[float, float]:
    """Median ms of train steps 2-6 (and the peak MiB allocated over the six)
    of chip_smoke.py's phase-12 text model
    (batch 64, 196 frames) or, with ``action``, its phase-13 action model
    (batch 64, 60 frames, lambdas rcxyz, vel and fc through a synthetic SMPL
    pickle of 6890 vertices under the tree's build/)."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.train.loop import (
        TrainConfig,
        TrainState,
        make_optimizer,
        train_step,
    )

    torch.set_grad_enabled(True)
    dev = torch.device("cuda")
    torch.manual_seed(5)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    b, fk_fn = cs.MB, None
    if action:
        from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
        from gesturediffusion_tpu_torch.models.smpl import (
            load_smpl_pickle,
            save_synthetic_smpl_pickle,
        )
        from gesturediffusion_tpu_torch.ops.rotations import (
            matrix_to_rotation_6d,
            rotation_6d_to_matrix,
        )

        base = os.path.join(os.path.abspath(root), "build", "take_ab")
        os.makedirs(base, exist_ok=True)
        smpl = load_smpl_pickle(save_synthetic_smpl_pickle(
            os.path.join(base, "smpl.pkl"), n_vertices=cs.A2M_VERTS)).to(dev)

        def fk_fn(sample):
            return rotation2xyz(smpl, sample, pose_rep="rot6d", translation=True, glob=True,
                                jointstype="smpl", vertstrans=False)

        frames = cs.A2M_FRAMES
        model = MotionMDM(njoints=cs.A2M_J, nfeats=cs.A2M_F, latent_dim=cs.T2M_D,
                          ff_size=cs.FF, num_layers=cs.LAYERS, num_heads=cs.HEADS,
                          dropout=cs.RATE, cond_mode="action", num_actions=cs.A2M_ACTIONS,
                          cond_mask_prob=0.0, use_fused_train_encoder=True).to(dev)
        diffusion = create_diffusion(noise_schedule="cosine", steps=1000, lambda_rcxyz=1.0,
                                     lambda_vel=1.0, lambda_fc=1.0, device=dev)
        rot = matrix_to_rotation_6d(rotation_6d_to_matrix(rn(b, 24, frames, 6, scale=0.3)))
        trans = torch.zeros(b, 1, frames, 6, device=dev)
        motion = torch.cat([rot, trans], dim=1).permute(0, 1, 3, 2).contiguous()
        noise = rn(b, cs.A2M_J, cs.A2M_F, frames)
        cond = {"action": torch.randint(0, cs.A2M_ACTIONS, (b,), generator=gen, device=dev)}
    else:
        frames = cs.T2M_FRAMES
        model = MotionMDM(njoints=cs.T2M_J, latent_dim=cs.T2M_D, ff_size=cs.FF,
                          num_layers=cs.LAYERS, num_heads=cs.HEADS, dropout=cs.RATE,
                          cond_mode="text", cond_mask_prob=0.1,
                          use_fused_train_encoder=True).to(dev)
        diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)
        motion, noise = rn(b, cs.T2M_J, 1, frames) * 0.5, rn(b, cs.T2M_J, 1, frames)
        cond = {"text_emb": rn(b, 512, scale=0.1)}
    cond["mask"] = torch.ones((b, 1, 1, frames), dtype=torch.bool, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=b)
    state = TrainState(model, *make_optimizer(model.parameters(), cfg), UniformSampler(1000), {})
    steps = torch.randint(0, 1000, (b,), generator=gen, device=dev)
    step_gen = torch.Generator(device=dev).manual_seed(7)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, diffusion, cfg, motion, cond, step_gen, steps, noise, fk_fn=fk_fn)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times[1:])[2] * 1e3, torch.cuda.max_memory_allocated() / 2**20


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one_tree(argv[1])))
        return 0
    import torch

    if not torch.cuda.is_available() or not argv:
        print("take_ab: needs a CUDA card and at least one tree", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             check=True, capture_output=True, text=True, cwd=HERE).stdout
        r = json.loads(out.strip().splitlines()[-1])
        print(f"take A/B {root}: " + ", ".join(
            f"{k} {v['ms_per_step']:.3f} ms/step = {v['chunks_per_s']:.3f} chunks/s"
            for k, v in r.items() if k.startswith("T=")) + ", " + ", ".join(
            f"{k} step {r[k]['ms']:.3f} ms = {r[k]['samples_per_s']:.1f} samples/s (peak "
            f"{r[k]['peak_mib']:.1f} MiB)" for k in ("train", "t2m train", "a2m train"))
            + ", t2m step " + ", ".join(
            f"{k} {v:.4f}" for k, v in r["t2m"].items()) + ", kernel 1's host ms a call "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["layer_host"].items()) + ", kernels " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in r["train_kernels"].items()) + f" [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
