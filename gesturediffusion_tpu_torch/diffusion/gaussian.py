"""Gaussian diffusion process math.

PyTorch counterpart of gesturediffusion_tpu/diffusion/gaussian.py
(GaussianDiffusion :78-424 and create_diffusion :427-526): the schedule
arrays, respacing through ``timestep_map``, q_mean_variance, q_sample,
the posterior, the x0/eps converters, p_mean_variance with fixed or learned variances,
inpainting, ``clip_denoised`` and ``denoised_fn``, the classifier-guidance
shifts ``condition_mean`` and ``condition_score``, and the training losses
(masked MSE for START_X / EPSILON / PREVIOUS_X, the learned-variance ``vb``
term, the velocity term, and the geometric terms on the xyz joints that
the caller's ``fk_fn`` gives: ``rcxyz_mse``, ``vel_xyz_mse`` and the
foot-contact ``fc``).  Every array is computed in float64 numpy and cast
to float32, as the JAX package does.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.diffusion import schedules
from gesturediffusion_tpu_torch.diffusion.losses import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
    sum_flat,
)


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


# model_fn(x, t_model, cond) -> model output, same shape as x
ModelFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]
# cond_fn(x, t_model, cond) -> grad_x log p(y | x), same shape as x
CondFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]

# SMPL's ankles and feet (left ankle, left foot, right ankle, right foot):
# the joints of the foot-contact term
FOOT_JOINTS = (7, 10, 8, 11)


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
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor  # internal t -> model-facing t (respacing)
    num_timesteps: int
    original_num_steps: int
    model_mean_type: ModelMeanType
    model_var_type: ModelVarType
    loss_type: LossType = LossType.MSE
    lambda_rcxyz: float = 0.0
    lambda_vel: float = 0.0
    lambda_fc: float = 0.0
    lambda_vel_rcxyz: float = 0.0
    rescale_timesteps: bool = False

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Translate internal timesteps to the ids the model was trained on;
        with ``rescale_timesteps`` as float32 on a 1000-step scale
        (gaussian.py:126-130)."""
        new_t = self.timestep_map[t]
        if self.rescale_timesteps:
            return new_t.float() * (1000.0 / self.original_num_steps)
        return new_t

    def q_mean_variance(self, x_start, t):
        """Mean, variance and log variance of q(x_t | x_0)
        (gaussian.py:135-140)."""
        nd = x_start.dim()
        mean = _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
        variance = _extract(1.0 - self.alphas_cumprod, t, nd)
        log_variance = _extract(self.log_one_minus_alphas_cumprod, t, nd)
        return mean, variance, log_variance

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
        clip_denoised: bool = False,
        denoised_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        inpaint: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> dict[str, torch.Tensor]:
        """Run the model; mean/variance of p(x_{t-1} | x_t) plus x0.
        ``inpaint`` = (mask, motion) overwrites the x0 prediction where
        mask is set (START_X only); then ``denoised_fn`` and, with
        ``clip_denoised``, a clip to [-1, 1] process the x0 prediction
        before the posterior mean is taken from it."""
        nd = x.dim()
        model_output = model_fn(x, self.model_t(t), cond)
        learned = self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE)
        if learned:
            model_output, model_var_values = model_output.split(x.shape[1], dim=1)
        if inpaint is not None:
            if self.model_mean_type != ModelMeanType.START_X:
                raise ValueError("inpainting imputation supports START_X prediction only")
            mask, motion = inpaint
            model_output = torch.where(mask, motion, model_output)

        if self.model_var_type == ModelVarType.LEARNED:
            model_log_variance = model_var_values
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.LEARNED_RANGE:
            min_log = _extract(self.posterior_log_variance_clipped, t, nd)
            max_log = _extract(self.log_betas, t, nd)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = _extract(self.fixed_large_variance, t, nd)
            model_log_variance = _extract(self.fixed_large_log_variance, t, nd)
        else:
            model_variance = _extract(self.posterior_variance, t, nd)
            model_log_variance = _extract(self.posterior_log_variance_clipped, t, nd)

        def process_xstart(xs):
            if denoised_fn is not None:
                xs = denoised_fn(xs)
            return xs.clamp(-1.0, 1.0) if clip_denoised else xs

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self.predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        else:
            if self.model_mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            else:
                pred_xstart = process_xstart(self.predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    # classifier guidance (gaussian.py:270-287)
    def condition_mean(self, cond_fn: CondFn, p_mean_var: dict, x, t, cond) -> torch.Tensor:
        """The posterior mean shifted by variance * grad log p(y | x)."""
        gradient = cond_fn(x, self.model_t(t), cond)
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn: CondFn, p_mean_var: dict, x, t, cond) -> dict:
        """Song et al. (2020) score conditioning: eps shifted by
        -sqrt(1 - alpha_bar) * grad, x0 and the mean rederived from it."""
        alpha_bar = _extract(self.alphas_cumprod, t, x.dim())
        eps = self.predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, self.model_t(t), cond)
        out = dict(p_mean_var)
        out["pred_xstart"] = self.predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # ------------------------------------------------------------------ #
    # Losses (gaussian.py:289-424)
    # ------------------------------------------------------------------ #
    @staticmethod
    def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Length-mask-aware per-sample MSE.  a, b [B, J, F, T]; mask
        [B, 1, 1, T] -> [B].  A fully masked sample has loss 0 (the count is
        clamped to 1), not 0/0."""
        mask = mask.to(a.dtype)
        loss = sum_flat((a - b) ** 2 * mask)
        non_zero = sum_flat(mask) * (a.shape[1] * a.shape[2])
        return loss / non_zero.clamp(min=1.0)

    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, cond):
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, cond)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"]))
        kl = kl / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

    def training_losses(
        self,
        model_fn: ModelFn,
        x_start: torch.Tensor,
        t: torch.Tensor,
        cond: dict,
        *,
        mask: torch.Tensor,
        noise: torch.Tensor,
        fk_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> dict[str, torch.Tensor]:
        """Per-sample training losses [B] for one sampled timestep batch
        (gaussian.py:307-424).  ``fk_fn`` maps a sample to xyz joints
        [B, J, 3, T]; a nonzero geometric lambda without it raises.
        ``terms["loss"]`` sums rot_mse, vb (learned variances) and the
        lambda-weighted vel_mse, rcxyz_mse and fc; vel_xyz_mse is reported
        and, as in the reference, not summed."""
        x_t = self.q_sample(x_start, t, noise)
        terms: dict[str, torch.Tensor] = {}
        if self.loss_type.is_vb():
            terms["loss"] = self._vb_terms_bpd(model_fn, x_start, x_t, t, cond)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model_fn(x_t, self.model_t(t), cond)
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = model_output.split(x_t.shape[1], dim=1)
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=1)
            terms["vb"] = self._vb_terms_bpd(
                lambda *_args: frozen_out, x_start, x_t, t, cond
            )["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise

        terms["rot_mse"] = self.masked_l2(target, model_output, mask)

        if self.lambda_rcxyz > 0 or self.lambda_vel_rcxyz > 0 or self.lambda_fc > 0:
            if fk_fn is None:
                raise ValueError("geometric losses require fk_fn")
            target_xyz = fk_fn(target)
            model_output_xyz = fk_fn(model_output)
        if self.lambda_rcxyz > 0:
            terms["rcxyz_mse"] = self.masked_l2(target_xyz, model_output_xyz, mask)
        if self.lambda_vel_rcxyz > 0:
            t_vel = target_xyz[..., 1:] - target_xyz[..., :-1]
            m_vel = model_output_xyz[..., 1:] - model_output_xyz[..., :-1]
            terms["vel_xyz_mse"] = self.masked_l2(t_vel, m_vel, mask[..., 1:])
        if self.lambda_fc > 0:
            # the predicted feet's velocity where the ground-truth foot is
            # (nearly) still: a speed of at most 0.01 a frame
            feet = list(FOOT_JOINTS)
            gt_joint = target_xyz[:, feet]
            gt_step = gt_joint[..., 1:] - gt_joint[..., :-1]
            gt_vel = torch.sqrt((gt_step * gt_step).sum(dim=2))  # [B, 4, T-1]
            fc_mask = (gt_vel <= 0.01)[:, :, None, :]            # [B, 4, 1, T-1]
            pred_joint = model_output_xyz[:, feet]
            pred_vel = pred_joint[..., 1:] - pred_joint[..., :-1]
            pred_vel = torch.where(fc_mask, pred_vel, pred_vel.new_zeros(()))
            terms["fc"] = self.masked_l2(pred_vel, torch.zeros_like(pred_vel), mask[..., 1:])
        if self.lambda_vel > 0:
            # the last joint row is the root location and takes no part
            target_vel = target[..., 1:] - target[..., :-1]
            model_vel = model_output[..., 1:] - model_output[..., :-1]
            terms["vel_mse"] = self.masked_l2(
                target_vel[:, :-1], model_vel[:, :-1], mask[..., 1:]
            )

        # summed in the reference's order
        loss = terms["rot_mse"] + terms.get("vb", 0.0)
        for lam, name in ((self.lambda_vel, "vel_mse"), (self.lambda_rcxyz, "rcxyz_mse"),
                          (self.lambda_fc, "fc")):
            if name in terms:
                loss = loss + lam * terms[name]
        terms["loss"] = loss
        return terms


def create_diffusion(
    *,
    noise_schedule: str = "cosine",
    steps: int = 1000,
    timestep_respacing: str | None = None,
    model_mean_type: ModelMeanType = ModelMeanType.START_X,
    model_var_type: ModelVarType = ModelVarType.FIXED_SMALL,
    loss_type: LossType = LossType.MSE,
    lambda_rcxyz: float = 0.0,
    lambda_vel: float = 0.0,
    lambda_fc: float = 0.0,
    lambda_vel_rcxyz: float = 0.0,
    rescale_timesteps: bool = False,
    device=None,
) -> GaussianDiffusion:
    """Build a (optionally respaced) GaussianDiffusion on ``device``
    (gaussian.py:create_diffusion).  ``rescale_timesteps`` hands the model
    ``timestep_map[t] * 1000 / steps`` (:437,520); the model factory leaves
    it off, as JAX's does."""
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
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
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
        "alphas_cumprod_next": alphas_cumprod_next,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "log_one_minus_alphas_cumprod": np.log(1.0 - alphas_cumprod),
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
        "log_betas": np.log(betas),
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
        loss_type=loss_type,
        lambda_rcxyz=lambda_rcxyz,
        lambda_vel=lambda_vel,
        lambda_fc=lambda_fc,
        lambda_vel_rcxyz=lambda_vel_rcxyz,
        rescale_timesteps=rescale_timesteps,
    )
