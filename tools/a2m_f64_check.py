#!/usr/bin/env python3
"""Is the a2m train step's fused-against-plain gap float32 rounding that the
geometric losses amplify, or a fault of the training kernels?

    python3 tools/a2m_f64_check.py [--device cpu] [--layers 8] [--batch 64]
                                   [--seed 6] [--steps 1]

chip_smoke.py phase 13 holds 5 train steps of the action-mode MotionMDM
(25 rows of rot6d, D 512, 8 layers of heads of 128, 60 frames, batch 64)
through the training kernels against the same steps through the plain
layer.  With the recipe's lambdas (rcxyz, vel, fc through SMPL's chain at
6890 vertices) the gap is ~100x the text-to-motion step's.  This script
takes one step's loss and gradients from one batch in three ways: the
kernels in float32, the plain layer in float32, the plain layer in float64
(model, SMPL, diffusion tables and batch), with the recipe's lambdas and
with every lambda at 0, the positional encoding's dropout off (its
Bernoulli draws differ between dtypes; the layers' hash dropout does
not).  For each pair it prints the loss's relative difference and the
worst parameter's max|diff| / max|grad|, and the smallest norms of the
model output's 6D halves, where rotation_6d_to_matrix divides by the norm:
a rotation's direction moves by about d / r for a change d of a 3-vector
of norm r.  If float32 against float64 shows the same gap for the plain
layer as for the kernels, and the gap goes with the lambdas, the kernels
are at float32 level and the loss's conditioning at random weights is what
the comparison reads.  With ``--steps N`` (N > 1) it then trains N steps
(train/loop.py:train_step, AdamW at lr 1e-4, the recipe's lambdas, N
batches from the seed) in the same three ways and prints each step's loss
and the relative gaps between them, as chip_smoke.py phase 13 compares its
5 steps: whether a gap that opens after the first update opens for plain
float32 too; and, teacher-forced, from the plain float32 run's weights
before each step k, step k's loss and gradients four ways (the kernels in
float32, the plain layer in float32, in float64, and in float32 from
weights nudged by one ulp), as chip_smoke.py's teacher-forced comparison
holds the kernels' step against the plain step.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> dict:
    """Prints the gaps and returns them: {lambdas label: {pair: (loss rel,
    worst grad max|diff|/max|grad|, its parameter, model output max|diff|)}}."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
    from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl
    from gesturediffusion_tpu_torch.ops.rotations import (
        matrix_to_rotation_6d,
        rotation_6d_to_matrix,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--latent_dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--vertices", type=int, default=6890)
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--steps", type=int, default=1)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())

    torch.manual_seed(a.seed)
    model = MotionMDM(njoints=25, nfeats=6, latent_dim=a.latent_dim, ff_size=1024,
                      num_layers=a.layers, num_heads=4, dropout=0.1, cond_mode="action",
                      cond_mask_prob=0.0, use_fused_train_encoder=True).to(dev)
    model.sequence_pos_encoder.dropout = 0.0
    smpl = make_synthetic_smpl(a.vertices).to(dev)
    rs = np.random.RandomState(a.seed)
    b, t = a.batch, a.frames

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(dev)

    rot = matrix_to_rotation_6d(rotation_6d_to_matrix(randn(b, 24, t, 6, scale=0.3)))
    trans = torch.zeros(b, 1, t, 6, device=dev)
    trans[..., :3] = torch.cumsum(randn(b, 1, t, 3, scale=0.01), dim=2)
    motion = torch.cat([rot, trans], dim=1).permute(0, 1, 3, 2).contiguous()
    lengths = rs.randint(2 * t // 3, t + 1, size=b)
    mask = torch.from_numpy(np.arange(t)[None] < lengths[:, None])[:, None, None].to(dev)
    action = torch.from_numpy(rs.randint(0, 12, size=b)).to(dev)
    tt = torch.from_numpy(rs.randint(0, 1000, size=b)).to(dev)
    noise = randn(b, 25, 6, t)
    batches = [(motion, mask, action, tt, noise)]
    for _ in range(a.steps - 1):
        rot = matrix_to_rotation_6d(rotation_6d_to_matrix(randn(b, 24, t, 6, scale=0.3)))
        trans = torch.zeros(b, 1, t, 6, device=dev)
        trans[..., :3] = torch.cumsum(randn(b, 1, t, 3, scale=0.01), dim=2)
        lengths = rs.randint(2 * t // 3, t + 1, size=b)
        batches.append((torch.cat([rot, trans], dim=1).permute(0, 1, 3, 2).contiguous(),
                        torch.from_numpy(np.arange(t)[None] < lengths[:, None])[:, None, None]
                        .to(dev), torch.from_numpy(rs.randint(0, 12, size=b)).to(dev),
                        torch.from_numpy(rs.randint(0, 1000, size=b)).to(dev),
                        randn(b, 25, 6, t)))

    def setup(dtype, lambdas):
        diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev, **lambdas)
        diffusion = dataclasses.replace(diffusion, **{
            f.name: getattr(diffusion, f.name).to(dtype) for f in dataclasses.fields(diffusion)
            if isinstance(getattr(diffusion, f.name), torch.Tensor)
            and getattr(diffusion, f.name).is_floating_point()})
        body = copy.deepcopy(smpl).to(dtype)

        def fk_fn(s):
            return rotation2xyz(body, s, pose_rep="rot6d", translation=True, glob=True,
                                jointstype="smpl", vertstrans=False)
        return diffusion, fk_fn

    def run(m, dtype, lambdas, batch=None):
        motion, mask, action, tt, noise = batch or batches[0]
        diffusion, fk_fn = setup(dtype, lambdas)
        m = m.to(dtype)

        gen = torch.Generator(device=dev).manual_seed(7)
        m.zero_grad(set_to_none=True)
        out = {}

        def model_fn(x, ts, cc):
            y = m(x, ts, cc, train=True, generator=gen)
            out["y"] = y.detach()
            return y

        with torch.enable_grad():
            terms = diffusion.training_losses(
                model_fn, motion.to(dtype), tt, {"action": action, "mask": mask},
                mask=mask, noise=noise.to(dtype), fk_fn=fk_fn if lambdas else None)
            loss = terms["loss"].mean()
            loss.backward()
        return (loss.item(), {n: p.grad.double().clone() for n, p in m.named_parameters()},
                out["y"].double())

    def gap(x, y):
        worst = max(((x[1][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                    for n, g in y[1].items())
        return abs(x[0] - y[0]) / abs(y[0]), worst

    result = {}
    for label, lambdas in (("recipe lambdas (rcxyz 1, vel 1, fc 1)",
                            dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0)),
                           ("every lambda 0", {})):
        fused = copy.deepcopy(model)
        plain = copy.deepcopy(model)
        plain.use_kernels = False
        wide = copy.deepcopy(plain)
        r_fused = run(fused, torch.float32, lambdas)
        r_plain = run(plain, torch.float32, lambdas)
        r_wide = run(wide, torch.float64, lambdas)
        print(f"{label}: loss {r_wide[0]:.6f}")
        result[label] = {}
        for name, x, y in (("kernels f32 vs plain f32", r_fused, r_plain),
                           ("kernels f32 vs plain f64", r_fused, r_wide),
                           ("plain f32   vs plain f64", r_plain, r_wide)):
            (loss_rel, (grad_rel, worst)) = gap(x, y)
            out_diff = (x[2] - y[2]).abs().max().item()
            result[label][name] = (loss_rel, grad_rel, worst, out_diff)
            print(f"  {name}: loss rel {loss_rel:.3e}, worst grad max|diff|/max|grad| "
                  f"{grad_rel:.3e} ({worst}); model output max|diff| {out_diff:.3e}")
        y = r_wide[2][:, :24]  # [B, 24, 6, T]
        norms = torch.cat([y[:, :, :3].norm(dim=2), y[:, :, 3:].norm(dim=2)]).flatten()
        print(f"  the model output's 6D halves: smallest norms "
              f"{[round(v, 5) for v in norms.sort().values[:5].tolist()]} of {norms.numel()}, "
              f"median {norms.median().item():.3f}")
    if a.steps > 1:
        result["steps"] = train_steps(model, batches, setup, dev)
        result["teacher_forced"] = teacher_forced(model, batches, run, gap, setup, dev)
    return result


def teacher_forced(model, batches, run, gap, setup, dev) -> list:
    """Step k's gradients from the plain float32 run's weights before step
    k (AdamW at lr 1e-4, the recipe's lambdas): the kernels in float32, the
    plain layer in float32 and float64, and the plain layer from those
    weights nudged by one ulp.  Prints each pair's loss rel and worst
    gradient max|diff| / max|grad| (with its parameter), returns them."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.train.loop import (
        TrainConfig,
        TrainState,
        make_optimizer,
        train_step,
    )

    recipe = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0)
    cfg = TrainConfig(lr=1e-4, batch_size=batches[0][0].shape[0])
    m = copy.deepcopy(model)
    m.use_kernels = False
    diffusion, fk_fn = setup(torch.float32, recipe)
    state = TrainState(m, *make_optimizer(m.parameters(), cfg), UniformSampler(1000), {})
    gen = torch.Generator(device=dev).manual_seed(7)
    out = []
    print("teacher-forced: step k from the plain f32 run's weights before it")
    for k, batch in enumerate(batches):
        ways = {}
        for name, kernels, dtype, nudge in (("kernels f32", True, torch.float32, False),
                                            ("plain f32", False, torch.float32, False),
                                            ("plain f64", False, torch.float64, False),
                                            ("plain f32 +1ulp", False, torch.float32, True)):
            c = copy.deepcopy(m)
            c.use_kernels = kernels
            if nudge:
                with torch.no_grad():
                    for p in c.parameters():
                        p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
            ways[name] = run(c, dtype, recipe, batch)
        row = {}
        for name, x, y in (("kernels f32 vs plain f32", "kernels f32", "plain f32"),
                           ("kernels f32 vs plain f64", "kernels f32", "plain f64"),
                           ("plain f32   vs plain f64", "plain f32", "plain f64"),
                           ("+1ulp f32   vs plain f32", "plain f32 +1ulp", "plain f32")):
            loss_rel, (grad_rel, worst) = gap(ways[x], ways[y])
            row[name] = (loss_rel, grad_rel, worst)
        print(f"  step {k + 1}: " + "; ".join(
            f"{name} loss {v[0]:.3e} grad {v[1]:.3e} ({v[2]})" for name, v in row.items()))
        out.append(row)
        x, mask, action, tt, noise = batch
        train_step(state, diffusion, cfg, x, {"action": action, "mask": mask}, gen, tt, noise,
                   fk_fn=fk_fn)
    return out


def train_steps(model, batches, setup, dev) -> dict:
    """Each step's loss through the kernels in float32, the plain layer in
    float32 and in float64, with the recipe's lambdas; prints them and the
    relative gaps, returns {path: losses}."""
    import copy

    import torch

    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.train.loop import (
        TrainConfig,
        TrainState,
        make_optimizer,
        train_step,
    )

    cfg = TrainConfig(lr=1e-4, batch_size=batches[0][0].shape[0])
    recipe = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0)
    losses = {}
    for name, kernels, dtype in (("kernels f32", True, torch.float32),
                                 ("plain f32", False, torch.float32),
                                 ("plain f64", False, torch.float64)):
        m = copy.deepcopy(model).to(dtype)
        m.use_kernels = kernels
        diffusion, fk_fn = setup(dtype, recipe)
        state = TrainState(m, *make_optimizer(m.parameters(), cfg), UniformSampler(1000), {})
        gen = torch.Generator(device=dev).manual_seed(7)
        losses[name] = [train_step(state, diffusion, cfg, x.to(dtype),
                                   {"action": action, "mask": mask}, gen, tt, noise.to(dtype),
                                   fk_fn=fk_fn)["loss"].item()
                        for x, mask, action, tt, noise in batches]
    wide = losses["plain f64"]
    print(f"{len(batches)} train steps, losses (plain f64) {[round(v, 6) for v in wide]}")
    for name, x, y in (("kernels f32 vs plain f32", losses["kernels f32"], losses["plain f32"]),
                       ("kernels f32 vs plain f64", losses["kernels f32"], wide),
                       ("plain f32   vs plain f64", losses["plain f32"], wide)):
        print(f"  {name}: each step's loss rel "
              f"{[f'{abs(u - v) / abs(v):.3e}' for u, v in zip(x, y)]}")
    return losses


if __name__ == "__main__":
    main()
