"""DDPM and DDIM sampling loops, chunked autoregressive generation.

PyTorch counterpart of gesturediffusion_tpu/diffusion/sampling.py
(p_sample, p_sample_loop, ddim_sample, ddim_sample_loop, ar_chunk_step,
autoregressive_sample_loop), as Python loops.  Every Gaussian draw comes
from an explicit ``torch.Generator``; ``noise_fn(chunk, step, shape)``
replaces the draws so a test can replay the JAX chain's noise: step
``num_steps`` is the draw of x_T, step i the draw of the update at
timestep i, as the JAX loops fold them (sampling.py:50-52, 139, 262).
DDIM draws its per-step normal even at eta 0, as JAX does, so both loops
take the same draws from a generator.  ``inpaint=(mask, motion)`` imputes
the ground truth into every step's x0 prediction where mask is set (motion
editing; diffusion/gaussian.py:p_mean_variance), with the same draws.
PLMS and DPM++ wait (ROADMAP A3).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, ModelFn, _extract

NoiseFn = Callable[[int, int, tuple], torch.Tensor]
# (mask, motion): the x0 prediction takes motion where mask is set
Inpaint = Optional[tuple[torch.Tensor, torch.Tensor]]


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """1.0 where t != 0: no noise is added on the final step."""
    return (t != 0).float().reshape((-1,) + (1,) * (ndim - 1))


def _drawer(diffusion: GaussianDiffusion, shape: tuple, generator: torch.Generator,
            noise_fn: Optional[NoiseFn], chunk: int) -> Callable[[int], torch.Tensor]:
    """draw(step): the chain's normal at ``step`` (num_steps: x_T)."""
    device = diffusion.betas.device

    def draw(step: int) -> torch.Tensor:
        if noise_fn is not None:
            return noise_fn(chunk, step, shape).to(device=device, dtype=torch.float32)
        return torch.randn(shape, generator=generator, device=device)

    return draw


def p_sample(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: dict,
    noise: torch.Tensor,
    *,
    inpaint: Inpaint = None,
) -> dict[str, torch.Tensor]:
    """One ancestral DDPM step x_t -> x_{t-1} with the given noise."""
    out = diffusion.p_mean_variance(model_fn, x, t, cond, inpaint=inpaint)
    nonzero = _nonzero_mask(t, x.dim())
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
    inpaint: Inpaint = None,
) -> torch.Tensor:
    """The full ancestral chain from x_T ~ N(0, I); returns x_0 (float32).
    ``chunk`` only labels the draws for ``noise_fn``."""
    draw = _drawer(diffusion, shape, generator, noise_fn, chunk)
    num_steps = diffusion.num_timesteps
    x = draw(num_steps)
    for i in range(num_steps - 1, -1, -1):
        t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
        x = p_sample(diffusion, model_fn, x, t, cond, draw(i), inpaint=inpaint)["sample"]
    return x


def ddim_sample(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: dict,
    noise: torch.Tensor,
    *,
    eta: float = 0.0,
    inpaint: Inpaint = None,
) -> dict[str, torch.Tensor]:
    """One DDIM step x_t -> x_{t-1} with the given noise (deterministic at
    eta 0, where the noise is multiplied by 0)."""
    out = diffusion.p_mean_variance(model_fn, x, t, cond, inpaint=inpaint)
    eps = diffusion.predict_eps_from_xstart(x, t, out["pred_xstart"])
    nd = x.dim()
    alpha_bar = _extract(diffusion.alphas_cumprod, t, nd)
    alpha_bar_prev = _extract(diffusion.alphas_cumprod_prev, t, nd)
    sigma = (
        eta
        * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
        * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
    )
    mean_pred = (
        out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
        + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
    )
    sample = mean_pred + _nonzero_mask(t, nd) * sigma * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


@torch.no_grad()
def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    cond: dict,
    *,
    generator: torch.Generator,
    noise_fn: Optional[NoiseFn] = None,
    chunk: int = 0,
    eta: float = 0.0,
    inpaint: Inpaint = None,
) -> torch.Tensor:
    """The full DDIM chain from x_T ~ N(0, I), the draws of
    ``p_sample_loop``; returns x_0 (float32)."""
    draw = _drawer(diffusion, shape, generator, noise_fn, chunk)
    num_steps = diffusion.num_timesteps
    x = draw(num_steps)
    for i in range(num_steps - 1, -1, -1):
        t = torch.full((shape[0],), i, dtype=torch.long, device=x.device)
        x = ddim_sample(diffusion, model_fn, x, t, cond, draw(i), eta=eta,
                        inpaint=inpaint)["sample"]
    return x


# the loops ar_chunk_step runs, by sampler name (JAX sample/generate.py:151)
LOOPS = {"ddpm": p_sample_loop, "ddim": ddim_sample_loop}


def sample_loop(sampler: str) -> Callable:
    """The loop of ``sampler``; PLMS and DPM++ are not ported yet."""
    if sampler in ("plms", "dpmpp"):
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet (ROADMAP A3)")
    if sampler not in LOOPS:
        raise ValueError(f"unknown sampler {sampler!r}")
    return LOOPS[sampler]


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
    loop: Callable = p_sample_loop,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the chunked-AR protocol: inject the carried seed poses
    into the conditioning, run one denoise ``loop``, hand off the last
    ``seed_poses`` frames.  The one definition of the per-chunk math: the
    batch loop and the streaming session (serve/streaming.py) both call
    it.  Returns ``(chunk, handoff_seed)``."""
    cond = dict(cond_c)
    cond["seed"] = seed
    if cond_precompute is not None:
        cond = cond_precompute(cond)
    out = loop(
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
    loop: Callable = p_sample_loop,
) -> torch.Tensor:
    """Chunked autoregressive generation: the last ``seed_poses`` frames of
    chunk k seed chunk k+1, each chunk one denoise ``loop``.

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
            cond_precompute=cond_precompute, loop=loop,
        )
        outs.append(out)
    return torch.stack(outs)
