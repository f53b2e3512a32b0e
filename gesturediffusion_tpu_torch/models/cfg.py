"""Classifier-free guidance as a model_fn combinator.

PyTorch counterpart of gesturediffusion_tpu/models/cfg.py: the cond and
uncond problems are stacked on the batch axis and run as one 2B forward;
``out_uncond + scale * (out_cond - out_uncond)`` with the per-sample
scale from ``cond['scale']``.
"""

from __future__ import annotations

from typing import Callable

import torch


def stack_cfg_cond(cond: dict, b: int, dtype=torch.float32) -> dict:
    """Duplicate every per-sample conditioning tensor on the batch axis and
    append the uncond mask [zeros(B), ones(B)] (cfg.py:stack_cfg_cond)."""
    def stack(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() and leaf.shape[0] == b:
            return torch.cat([leaf, leaf], dim=0)
        return leaf

    cond2 = {k: stack(v) for k, v in cond.items() if k != "uncond"}
    device = next(v.device for v in cond.values() if isinstance(v, torch.Tensor))
    cond2["uncond"] = torch.cat([
        torch.zeros((b,), dtype=dtype, device=device),
        torch.ones((b,), dtype=dtype, device=device),
    ])
    return cond2


def classifier_free_guidance(model_fn: Callable, cond_mask_prob: float = 0.1) -> Callable:
    """Wrap a model_fn(x, t, cond) with batched classifier-free guidance
    (cfg.py:classifier_free_guidance)."""
    if not cond_mask_prob > 0.0:
        raise ValueError("Cannot run CFG on a model trained without conditioning dropout")

    def guided(x: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        b = x.shape[0]
        scale = cond["scale"].reshape((b,) + (1,) * (x.dim() - 1))
        out = model_fn(
            torch.cat([x, x]), torch.cat([t, t]), stack_cfg_cond(cond, b, x.dtype)
        )
        out_cond, out_uncond = out[:b], out[b:]
        return out_uncond + scale * (out_cond - out_uncond)

    return guided
