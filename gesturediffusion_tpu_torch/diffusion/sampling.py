"""DDPM sampling loops, chunked autoregressive generation.

PyTorch counterpart of gesturediffusion_tpu/diffusion/sampling.py
(p_sample, p_sample_loop, ar_chunk_step, autoregressive_sample_loop),
DDPM only, as Python loops.  Every Gaussian draw comes from an explicit
``torch.Generator``; ``noise_fn(chunk, step, shape)`` replaces the draws
so a test can replay the JAX chain's noise: step ``num_steps`` is the
draw of x_T, step i the draw of the update at timestep i, as the JAX
loops fold them (sampling.py:50-52, 139).  DDIM, PLMS and DPM++ wait.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, ModelFn

NoiseFn = Callable[[int, int, tuple], torch.Tensor]


def p_sample(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: dict,
    noise: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """One ancestral DDPM step x_t -> x_{t-1} with the given noise."""
    out = diffusion.p_mean_variance(model_fn, x, t, cond)
    nonzero = (t != 0).float().reshape((-1,) + (1,) * (x.dim() - 1))
    sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


@torch.no_grad()
def p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    cond: dict,
    *,
    generator: torch.Generator,
    noise_fn: Optional[NoiseFn] = None,
    chunk: int = 0,
) -> torch.Tensor:
    """The full ancestral chain from x_T ~ N(0, I); returns x_0 (float32).
    ``chunk`` only labels the draws for ``noise_fn``."""
    device = diffusion.betas.device

    def draw(step: int) -> torch.Tensor:
        if noise_fn is not None:
            return noise_fn(chunk, step, shape).to(device=device, dtype=torch.float32)
        return torch.randn(shape, generator=generator, device=device)

    num_steps = diffusion.num_timesteps
    x = draw(num_steps)
    for i in range(num_steps - 1, -1, -1):
        t = torch.full((shape[0],), i, dtype=torch.long, device=device)
        x = p_sample(diffusion, model_fn, x, t, cond, draw(i))["sample"]
    return x


def ar_chunk_step(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    k: int,
    cond_c: dict,
    seed: torch.Tensor,
    seed_poses: int,
    *,
    generator: torch.Generator,
    noise_fn: Optional[NoiseFn] = None,
    cond_precompute: Optional[Callable] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the chunked-AR protocol: inject the carried seed poses
    into the conditioning, run one denoise loop, hand off the last
    ``seed_poses`` frames.  Returns ``(chunk, handoff_seed)``."""
    cond = dict(cond_c)
    cond["seed"] = seed
    if cond_precompute is not None:
        cond = cond_precompute(cond)
    out = p_sample_loop(
        diffusion, model_fn, shape, cond, generator=generator, noise_fn=noise_fn, chunk=k
    )
    return out, out[..., -seed_poses:]


@torch.no_grad()
def autoregressive_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    chunk_conds: dict,
    init_seed: torch.Tensor,
    seed_poses: int,
    *,
    generator: torch.Generator,
    noise_fn: Optional[NoiseFn] = None,
    cond_precompute: Optional[Callable] = None,
) -> torch.Tensor:
    """Chunked autoregressive generation: the last ``seed_poses`` frames of
    chunk k seed chunk k+1.

    chunk_conds: per-chunk conditioning tensors with a leading chunk axis
      [C, ...] (mfcc, scale, ...; without 'seed').
    init_seed: [B, J, F, S] seed poses of the first chunk.
    Returns [C, B, J, F, T].
    """
    n_chunks = next(iter(chunk_conds.values())).shape[0]
    seed, outs = init_seed, []
    for k in range(n_chunks):
        out, seed = ar_chunk_step(
            diffusion, model_fn, shape, k, {n: v[k] for n, v in chunk_conds.items()},
            seed, seed_poses, generator=generator, noise_fn=noise_fn,
            cond_precompute=cond_precompute,
        )
        outs.append(out)
    return torch.stack(outs)
