"""Beta schedules and timestep respacing, in float64 numpy.

Copy of gesturediffusion_tpu/diffusion/schedules.py (get_named_beta_schedule,
space_timesteps, respacing_string, respaced_betas and their helpers) for
the PyTorch port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def betas_for_alpha_bar(
    num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999
) -> np.ndarray:
    """Discretize a cumulative-alpha function into per-step betas."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int, scale_betas: float = 1.0
) -> np.ndarray:
    """Named beta schedule: 'linear' (Ho et al., step-count invariant scaling)
    or 'cosine' (Nichol & Dhariwal)."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(
    num_timesteps: int, section_counts, betas=None
) -> set[int]:
    """Choose a subset of original timesteps for respaced (fewer-step) sampling.

    ``section_counts`` is either a comma-separated string of per-section step
    counts, the literal ``"ddimN"`` (stride chosen to produce exactly N steps),
    ``"logsnrN"`` (N steps uniform in log-SNR λ = ½·log(ᾱ/(1−ᾱ)) — needs
    ``betas``; concentrates steps where the ODE moves fastest, which is
    where low-step solvers like DPM-Solver++ earn their order), or a list
    of ints.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("logsnr"):
            if betas is None:
                raise ValueError(
                    "logsnr spacing needs the schedule's betas to compute "
                    "log-SNR values (pass timestep_respacing to "
                    "create_diffusion, which forwards them)"
                )
            n = int(section_counts[len("logsnr"):])
            if not 2 <= n <= num_timesteps:
                raise ValueError(
                    f"logsnr step count {n} not in [2, {num_timesteps}]"
                )
            ac = np.cumprod(1.0 - np.asarray(betas, np.float64))
            lam = 0.5 * (np.log(ac) - np.log1p(-ac))
            targets = np.linspace(lam[0], lam[-1], n)
            idx = {int(np.argmin(np.abs(lam - t))) for t in targets}
            # λ-plateau collisions: top up from uniform positions
            for i in np.round(
                np.linspace(0, num_timesteps - 1, n)
            ).astype(int):
                if len(idx) >= n:
                    break
                idx.add(int(i))
            return idx
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        if section_count <= 1:
            frac_stride = 1
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


def respacing_string(
    sample_steps: int | None,
    sampler: str = "ddpm",
    spacing: str = "uniform",
) -> str | None:
    """The one mapping from (sample_steps, sampler, spacing) to a
    ``timestep_respacing`` string, which the streaming session and the
    serving CLI share.  Returns None for no respacing (the full trained
    chain)."""
    if spacing not in ("uniform", "logsnr"):
        raise ValueError(
            f"unknown step spacing {spacing!r} (uniform | logsnr)"
        )
    if not sample_steps:
        if spacing != "uniform":
            # the full chain visits every step — there is nothing for a
            # non-uniform spacing to choose; ignoring it would lie
            raise ValueError(
                f"step spacing {spacing!r} requires sample_steps "
                "(the full chain is not respaced)"
            )
        return None
    if spacing == "logsnr":
        return f"logsnr{sample_steps}"
    if sampler == "ddim":
        return f"ddim{sample_steps}"
    return str(sample_steps)


def respaced_betas(
    base_betas: np.ndarray, use_timesteps: set[int]
) -> tuple[np.ndarray, np.ndarray]:
    """Recompute betas over a kept timestep subset.

    Returns ``(new_betas, timestep_map)`` where ``timestep_map[i]`` is the
    original timestep index of respaced step ``i`` (reference surface:
    diffusion/respace.py:79-87,117-129).
    """
    alphas_cumprod = np.cumprod(1.0 - np.asarray(base_betas, np.float64))
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return np.array(new_betas, np.float64), np.array(timestep_map, np.int64)
