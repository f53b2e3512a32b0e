"""Sampling loops (DDPM, DDIM, PLMS, DPM-Solver++), chunked autoregressive
generation.

PyTorch counterpart of gesturediffusion_tpu/diffusion/sampling.py
(p_sample, p_sample_loop, ddim_sample, ddim_reverse_sample,
ddim_sample_loop, plms_sample_loop, dpmpp_sample_loop, ar_chunk_step,
autoregressive_sample_loop, make_sample_fn), as Python loops.  Every
Gaussian draw comes from an explicit ``torch.Generator``;
``noise_fn(chunk, step, shape)`` replaces the draws so a test can replay
the JAX chain's noise: step ``num_steps`` is the draw of x_T, step i the
draw of the update at timestep i, as the JAX loops fold them
(sampling.py:50-52, 139, 262).  DDIM draws its per-step normal even at eta
0, as JAX does, so both loops take the same draws from a generator; PLMS
and DPM++ are deterministic after x_T and draw only x_T.  ``noise=`` gives
x_T itself (no draw); ``skip_timesteps`` shortens the chain, whose x_T is
then ``init_image`` (zeros if not given) noised to the first step run.
``inpaint=(mask, motion)`` imputes the ground truth into every step's x0
prediction where mask is set (motion editing), with the same draws;
``clip_denoised`` and ``denoised_fn`` process every x0 prediction, and
``cond_fn`` guides the DDPM mean (``condition_mean``) or the other loops'
score (``condition_score``), as in diffusion/gaussian.py.  Under
parallel/distributed.py:global_rows (a take split over ranks) every draw,
``noise_fn``'s too, is of the global batch, and the rank keeps its rows.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import (
    CondFn,
    GaussianDiffusion,
    ModelFn,
    _extract,
)
from gesturediffusion_tpu_torch.parallel.distributed import draw_rows

NoiseFn = Callable[[int, int, tuple], torch.Tensor]
# (mask, motion): the x0 prediction takes motion where mask is set
Inpaint = Optional[tuple[torch.Tensor, torch.Tensor]]
DenoisedFn = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """1.0 where t != 0: no noise is added on the final step."""
    return (t != 0).float().reshape((-1,) + (1,) * (ndim - 1))


def _drawer(diffusion: GaussianDiffusion, shape: tuple, generator: torch.Generator,
            noise_fn: Optional[NoiseFn], chunk: int) -> Callable[[int], torch.Tensor]:
    """draw(step): the chain's normal at ``step`` (num_steps: x_T)."""
    device = diffusion.betas.device

    def draw(step: int) -> torch.Tensor:
        if noise_fn is not None:
            return draw_rows(shape, lambda s: noise_fn(chunk, step, s)).to(
                device=device, dtype=torch.float32)
        return draw_rows(shape, lambda s: torch.randn(s, generator=generator, device=device))

    return draw


def _init_sample(diffusion: GaussianDiffusion, shape: tuple, draw: Callable,
                 noise: Optional[torch.Tensor], skip_timesteps: int,
                 init_image: Optional[torch.Tensor]) -> tuple[torch.Tensor, int]:
    """The chain's start and the number of steps to run (sampling.py:39-61):
    x_T is ``noise`` or the draw at step num_steps; with ``skip_timesteps``
    or ``init_image`` it is init_image noised to timestep num_steps - 1."""
    num_steps = diffusion.num_timesteps - skip_timesteps
    x = (noise if noise is not None else draw(num_steps)).float()
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if init_image is not None:
        t0 = torch.full((shape[0],), num_steps - 1, dtype=torch.long, device=x.device)
        x = diffusion.q_sample(init_image, t0, x)
    return x, num_steps


def _timesteps(i: int, shape: tuple, device) -> torch.Tensor:
    return torch.full((shape[0],), i, dtype=torch.long, device=device)


def p_sample(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: dict,
    noise: torch.Tensor,
    *,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
    cond_fn: Optional[CondFn] = None,
    inpaint: Inpaint = None,
    const_noise: bool = False,
) -> dict[str, torch.Tensor]:
    """One ancestral DDPM step x_t -> x_{t-1} with the given noise
    (``const_noise``: the first row's noise for every row)."""
    out = diffusion.p_mean_variance(model_fn, x, t, cond, clip_denoised=clip_denoised,
                                    denoised_fn=denoised_fn, inpaint=inpaint)
    if const_noise:
        noise = noise[:1].expand(noise.shape)
    if cond_fn is not None:
        out["mean"] = diffusion.condition_mean(cond_fn, out, x, t, cond)
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
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
    cond_fn: Optional[CondFn] = None,
    inpaint: Inpaint = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    const_noise: bool = False,
    return_intermediates: bool = False,
    carry_dtype: Optional[torch.dtype] = None,
):
    """The full ancestral chain; returns x_0 (float32), or (x_0, every
    step's sample stacked) with ``return_intermediates``.  ``chunk`` only
    labels the draws for ``noise_fn``.  ``carry_dtype`` stores the chain
    state in that dtype between steps (each update stays float32)."""
    draw = _drawer(diffusion, shape, generator, noise_fn, chunk)
    x, num_steps = _init_sample(diffusion, shape, draw, noise, skip_timesteps, init_image)
    if carry_dtype is not None:
        x = x.to(carry_dtype)
    ys = []
    for i in range(num_steps - 1, -1, -1):
        x = p_sample(diffusion, model_fn, x, _timesteps(i, shape, x.device), cond, draw(i),
                     clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                     inpaint=inpaint, const_noise=const_noise)["sample"]
        if carry_dtype is not None:
            x = x.to(carry_dtype)
        if return_intermediates:
            ys.append(x)
    x = x.float()
    return (x, torch.stack(ys)) if return_intermediates else x


def _guided(diffusion, model_fn, x, t, cond, clip_denoised, denoised_fn, cond_fn, inpaint):
    """(p_mean_variance's output, the same under condition_score)."""
    out = diffusion.p_mean_variance(model_fn, x, t, cond, clip_denoised=clip_denoised,
                                    denoised_fn=denoised_fn, inpaint=inpaint)
    if cond_fn is None:
        return out, out
    return out, diffusion.condition_score(cond_fn, out, x, t, cond)


def ddim_sample(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: dict,
    noise: torch.Tensor,
    *,
    eta: float = 0.0,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
    cond_fn: Optional[CondFn] = None,
    inpaint: Inpaint = None,
) -> dict[str, torch.Tensor]:
    """One DDIM step x_t -> x_{t-1} with the given noise (deterministic at
    eta 0, where the noise is multiplied by 0)."""
    out_orig, out = _guided(diffusion, model_fn, x, t, cond, clip_denoised, denoised_fn,
                            cond_fn, inpaint)
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
    return {"sample": sample, "pred_xstart": out_orig["pred_xstart"]}


@torch.no_grad()
def ddim_reverse_sample(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    cond: dict,
    *,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
) -> dict[str, torch.Tensor]:
    """One step of the deterministic DDIM reverse ODE, x_t -> x_{t+1}."""
    out = diffusion.p_mean_variance(model_fn, x, t, cond, clip_denoised=clip_denoised,
                                    denoised_fn=denoised_fn)
    eps = diffusion.predict_eps_from_xstart(x, t, out["pred_xstart"])
    alpha_bar_next = _extract(diffusion.alphas_cumprod_next, t, x.dim())
    mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                 + torch.sqrt(1 - alpha_bar_next) * eps)
    return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}


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
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
    cond_fn: Optional[CondFn] = None,
    inpaint: Inpaint = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    return_intermediates: bool = False,
):
    """The full DDIM chain, the draws of ``p_sample_loop``; returns x_0
    (float32), or (x_0, every step's sample) with
    ``return_intermediates``."""
    draw = _drawer(diffusion, shape, generator, noise_fn, chunk)
    x, num_steps = _init_sample(diffusion, shape, draw, noise, skip_timesteps, init_image)
    ys = []
    for i in range(num_steps - 1, -1, -1):
        x = ddim_sample(diffusion, model_fn, x, _timesteps(i, shape, x.device), cond, draw(i),
                        eta=eta, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                        cond_fn=cond_fn, inpaint=inpaint)["sample"]
        if return_intermediates:
            ys.append(x)
    return (x, torch.stack(ys)) if return_intermediates else x


# Adams-Bashforth coefficients of orders 1-4, oldest to newest
AB_COEFS = {
    1: [1.0],
    2: [-1.0 / 2, 3.0 / 2],
    3: [5.0 / 12, -16.0 / 12, 23.0 / 12],
    4: [-9.0 / 24, 37.0 / 24, -59.0 / 24, 55.0 / 24],
}


@torch.no_grad()
def plms_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    cond: dict,
    *,
    generator: torch.Generator,
    noise_fn: Optional[NoiseFn] = None,
    chunk: int = 0,
    order: int = 2,
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
    cond_fn: Optional[CondFn] = None,
    inpaint: Inpaint = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pseudo linear multistep (Adams-Bashforth of ``order`` 1-4) chain
    (sampling.py:286-402).  The first step of order > 1 is the pseudo
    improved-Euler warmup, one more model pass at t - 1; later steps
    combine the newest eps predictions; the final step returns the
    guided x0 prediction."""
    if not 1 <= int(order) <= 4:
        raise ValueError("order must be an int in [1, 4]")
    order = int(order)
    draw = _drawer(diffusion, shape, generator, noise_fn, chunk)
    x, num_steps = _init_sample(diffusion, shape, draw, noise, skip_timesteps, init_image)

    def eps_xstart(xc, t):
        _, out = _guided(diffusion, model_fn, xc, t, cond, clip_denoised, denoised_fn,
                         cond_fn, inpaint)
        return diffusion.predict_eps_from_xstart(xc, t, out["pred_xstart"]), out["pred_xstart"]

    ring: list[torch.Tensor] = []  # the newest eps predictions, newest last
    for i in range(num_steps - 1, -1, -1):
        t = _timesteps(i, shape, x.device)
        eps, pred_xstart = eps_xstart(x, t)
        alpha_bar_prev = _extract(diffusion.alphas_cumprod_prev, t, x.dim())
        first = not ring
        ring = (ring + [eps])[-order:]
        if order == 1:
            eps_prime = eps
        elif first:
            mean_pred_1 = (pred_xstart * torch.sqrt(alpha_bar_prev)
                           + torch.sqrt(1 - alpha_bar_prev) * eps)
            eps_2, _ = eps_xstart(mean_pred_1, t - 1)
            eps_prime = (eps + eps_2) / 2
        else:
            eps_prime = torch.zeros_like(eps)
            for c, e in zip(AB_COEFS[len(ring)], ring):
                eps_prime = eps_prime + c * e
        pred_prime = diffusion.predict_xstart_from_eps(x, t, eps_prime)
        mean_pred = (pred_prime * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev) * eps_prime)
        nonzero = _nonzero_mask(t, x.dim())
        x = mean_pred * nonzero + pred_xstart * (1 - nonzero)
    return x


@torch.no_grad()
def dpmpp_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    shape: tuple[int, ...],
    cond: dict,
    *,
    generator: torch.Generator,
    noise_fn: Optional[NoiseFn] = None,
    chunk: int = 0,
    order: int = 2,
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
    denoised_fn: DenoisedFn = None,
    cond_fn: Optional[CondFn] = None,
    inpaint: Inpaint = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M), the multistep data-prediction solver of the
    probability-flow ODE (sampling.py:405-500), in log-SNR time
    lambda = log(alpha / sigma).  For the step t -> t-1, h = lambda_{t-1} -
    lambda_t and r = h_prev / h:

        D  = (1 + 1/(2r)) x0(x_t) - 1/(2r) x0(x_{t+1})
        x' = (sigma_{t-1} / sigma_t) x_t - alpha_{t-1} (e^-h - 1) D

    The first step (no history) and the last (sigma -> 0) are first order,
    which is DDIM at eta 0; ``order=1`` is first order throughout.  x0 is
    carried in float32."""
    if int(order) not in (1, 2):
        raise ValueError("dpmpp order must be 1 or 2 (2M)")
    second_order = int(order) == 2
    draw = _drawer(diffusion, shape, generator, noise_fn, chunk)
    x, num_steps = _init_sample(diffusion, shape, draw, noise, skip_timesteps, init_image)

    # log-SNR tables; alphas_cumprod_prev[0] is 1 (sigma_prev 0, lambda
    # +inf), kept finite by the floors
    ac, ac_prev = diffusion.alphas_cumprod, diffusion.alphas_cumprod_prev
    sigma_t = torch.sqrt(1.0 - ac)
    lam_t = 0.5 * (torch.log(ac) - torch.log1p(-ac))
    alpha_prev = torch.sqrt(ac_prev)
    sigma_prev = torch.sqrt(torch.clamp(1.0 - ac_prev, min=1e-40))
    lam_prev = torch.log(torch.clamp(alpha_prev, min=1e-20)) - torch.log(sigma_prev)

    x0_prev, h_prev = torch.zeros_like(x), None
    for i in range(num_steps - 1, -1, -1):
        t = _timesteps(i, shape, x.device)
        _, out = _guided(diffusion, model_fn, x, t, cond, clip_denoised, denoised_fn,
                         cond_fn, inpaint)
        x0 = out["pred_xstart"].float()
        h = lam_prev[i] - lam_t[i]
        if second_order and h_prev is not None and i > 0:
            c = 1.0 / (2.0 * (h_prev / h))
            d = (1.0 + c) * x0 - c * x0_prev
        else:
            d = x0
        x = (sigma_prev[i] / sigma_t[i]) * x - alpha_prev[i] * (torch.exp(-h) - 1.0) * d
        x0_prev, h_prev = x0, h
    return x


# the loops ar_chunk_step runs, by sampler name (JAX sample/generate.py:183-188)
LOOPS = {"ddpm": p_sample_loop, "ddim": ddim_sample_loop, "plms": plms_sample_loop,
         "dpmpp": dpmpp_sample_loop}


def sample_loop(sampler: str) -> Callable:
    """The loop of ``sampler`` (ddpm, ddim, plms or dpmpp)."""
    if sampler not in LOOPS:
        raise ValueError(f"unknown sampler {sampler!r}")
    return LOOPS[sampler]


def make_sample_fn(diffusion: GaussianDiffusion, sampler: str = "ddpm",
                   **default_kwargs) -> Callable:
    """The loop of ``sampler`` with ``diffusion`` and ``default_kwargs``
    bound (sampling.py:609)."""
    return partial(sample_loop(sampler), diffusion, **default_kwargs)


def check_time_axis(shape: tuple, time_axis: int) -> None:
    """The time axis of a sampling state of ``shape``: -1 (the last, the
    canonical [B, J, F, T]) or 1, only for the time-major [B, T, J*F]
    (sampling.py:584-593, with its messages: on a 4-D shape time_axis=1
    would slice the joint axis for the seed hand-off)."""
    if time_axis == 1 and len(shape) != 3:
        raise ValueError(
            "time_axis=1 requires the 3D time-major [B, T, J*F] shape; "
            f"got shape {tuple(shape)}"
        )
    if time_axis not in (-1, len(shape) - 1, 1):
        raise ValueError(f"unsupported time_axis {time_axis}")


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
    time_axis: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the chunked-AR protocol: inject the carried seed poses
    into the conditioning, run one denoise ``loop``, hand off the last
    ``seed_poses`` frames along ``time_axis`` (check_time_axis; 1 for the
    time-major fast path, whose hand-off is ``out[:, -S:]``).  The one
    definition of the per-chunk math: the batch loop and the streaming
    session (serve/streaming.py) both call it.  Returns ``(chunk,
    handoff_seed)``."""
    check_time_axis(shape, time_axis)
    cond = dict(cond_c)
    cond["seed"] = seed
    if cond_precompute is not None:
        cond = cond_precompute(cond)
    out = loop(
        diffusion, model_fn, shape, cond, generator=generator, noise_fn=noise_fn, chunk=k
    )
    return out, (out[:, -seed_poses:] if time_axis == 1 else out[..., -seed_poses:])


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
    time_axis: int = -1,
) -> torch.Tensor:
    """Chunked autoregressive generation: the last ``seed_poses`` frames of
    chunk k seed chunk k+1, each chunk one denoise ``loop``.

    chunk_conds: per-chunk conditioning tensors with a leading chunk axis
      [C, ...] (mfcc, scale, ...; without 'seed').
    init_seed: [B, J, F, S] seed poses of the first chunk (or [B, S, J*F]
      time-major).
    time_axis: the time axis of ``shape`` (check_time_axis): -1 for the
      canonical [B, J, F, T], 1 for the time-major [B, T, J*F] of the
      fast path's "btj" layout, whose carried seed is [B, S, J*F].
    Returns [C, B, J, F, T] ([C, B, T, J*F] at time_axis=1).
    """
    check_time_axis(shape, time_axis)
    n_chunks = next(iter(chunk_conds.values())).shape[0]
    seed, outs = init_seed, []
    for k in range(n_chunks):
        out, seed = ar_chunk_step(
            diffusion, model_fn, shape, k, {n: v[k] for n, v in chunk_conds.items()},
            seed, seed_poses, generator=generator, noise_fn=noise_fn,
            cond_precompute=cond_precompute, loop=loop, time_axis=time_axis,
        )
        outs.append(out)
    return torch.stack(outs)
