"""Gaussian diffusion process math, sampling half.

PyTorch counterpart of gesturediffusion_tpu/diffusion/gaussian.py
(GaussianDiffusion :78-265 and create_diffusion :427-526): the schedule
arrays, respacing through ``timestep_map``, q_sample, the posterior, the
x0/eps converters and p_mean_variance with fixed variances and inpainting.
Every array is computed in float64 numpy and cast to float32, as the JAX
package does.  ``training_losses`` and learned variances wait for the
training slice.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.diffusion import schedules


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


# model_fn(x, t_model, cond) -> model output, same shape as x
ModelFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Index a [T] schedule array at per-sample timesteps and broadcast."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


@dataclass(frozen=True)
class GaussianDiffusion:
    """Diffusion schedule (float32 tensors on one device) + process math."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor  # internal t -> model-facing t (respacing)
    num_timesteps: int
    original_num_steps: int
    model_mean_type: ModelMeanType
    model_var_type: ModelVarType

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Translate internal timesteps to the ids the model was trained on."""
        return self.timestep_map[t]

    def q_sample(self, x_start, t, noise):
        nd = x_start.dim()
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.dim()
        mean = (
            _extract(self.posterior_mean_coef1, t, nd) * x_start
            + _extract(self.posterior_mean_coef2, t, nd) * x_t
        )
        return (
            mean,
            _extract(self.posterior_variance, t, nd),
            _extract(self.posterior_log_variance_clipped, t, nd),
        )

    def predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.dim()
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps
        )

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.dim()
        return (
            _extract(1.0 / self.posterior_mean_coef1, t, nd) * xprev
            - _extract(self.posterior_mean_coef2 / self.posterior_mean_coef1, t, nd) * x_t
        )

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.dim()
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
        ) / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)

    def p_mean_variance(
        self,
        model_fn: ModelFn,
        x: torch.Tensor,
        t: torch.Tensor,
        cond: dict,
        *,
        inpaint: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> dict[str, torch.Tensor]:
        """Run the model; mean/variance of p(x_{t-1} | x_t) plus x0.
        ``inpaint`` = (mask, motion) overwrites the x0 prediction where
        mask is set (START_X only)."""
        nd = x.dim()
        model_output = model_fn(x, self.model_t(t), cond)
        if inpaint is not None:
            if self.model_mean_type != ModelMeanType.START_X:
                raise ValueError("inpainting imputation supports START_X prediction only")
            mask, motion = inpaint
            model_output = torch.where(mask, motion, model_output)

        if self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = _extract(self.fixed_large_variance, t, nd)
            model_log_variance = _extract(self.fixed_large_log_variance, t, nd)
        elif self.model_var_type == ModelVarType.FIXED_SMALL:
            model_variance = _extract(self.posterior_variance, t, nd)
            model_log_variance = _extract(self.posterior_log_variance_clipped, t, nd)
        else:
            raise NotImplementedError("learned variances wait for the training port")

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = self.predict_xstart_from_xprev(x, t, model_output)
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = model_output
            else:
                pred_xstart = self.predict_xstart_from_eps(x, t, model_output)
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }


def create_diffusion(
    *,
    noise_schedule: str = "cosine",
    steps: int = 1000,
    timestep_respacing: str | None = None,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
    device=None,
) -> GaussianDiffusion:
    """Build a (optionally respaced) GaussianDiffusion on ``device``
    (gaussian.py:create_diffusion)."""
    betas = schedules.get_named_beta_schedule(noise_schedule, steps)
    original_num_steps = len(betas)
    if timestep_respacing:
        use_timesteps = schedules.space_timesteps(
            original_num_steps, timestep_respacing, betas=betas
        )
        betas, timestep_map = schedules.respaced_betas(betas, use_timesteps)
    else:
        timestep_map = np.arange(original_num_steps, dtype=np.int64)
    if not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must lie in (0, 1]")
    num_timesteps = len(betas)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    if num_timesteps > 1:
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        )
        fixed_large_variance = np.append(posterior_variance[1], betas[1:])
    else:
        posterior_log_variance_clipped = np.log(np.maximum(posterior_variance, 1e-20))
        fixed_large_variance = betas.copy()

    arrays = {
        "betas": betas,
        "alphas_cumprod": alphas_cumprod,
        "alphas_cumprod_prev": alphas_cumprod_prev,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod - 1),
        "posterior_variance": posterior_variance,
        "posterior_log_variance_clipped": posterior_log_variance_clipped,
        "posterior_mean_coef1": betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        "posterior_mean_coef2": (
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        "fixed_large_variance": fixed_large_variance,
        "fixed_large_log_variance": np.log(fixed_large_variance),
    }
    tensors = {
        k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in arrays.items()
    }
    tensors["timestep_map"] = torch.from_numpy(timestep_map.astype(np.int64)).to(device)
    return GaussianDiffusion(
        **tensors,
        num_timesteps=num_timesteps,
        original_num_steps=original_num_steps,
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
    )
