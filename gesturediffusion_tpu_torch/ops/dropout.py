"""Dropout drawn from an explicit torch.Generator.

``F.dropout`` takes no generator, so the port draws its Bernoulli masks
itself.  Semantics of flax ``nn.Dropout`` (the JAX package's training
dropout): keep each element with probability 1 - rate and scale the kept
ones by 1 / (1 - rate).  Under parallel/distributed.py:global_rows the mask
is drawn for the global batch and this rank keeps its rows.

``GDT_SEED_DROPOUT=1``, read at every call that autograd records (never
under ``no_grad``), as JAX reads it at call time (ops/seed_dropout.py:116),
takes the seed-redrawn path of JAX's
``seed_dropout`` (:44-82): the forward draws the same mask from the same
generator, which advances as it does on the default path, but autograd
saves the generator's state in place of the mask, and the backward draws
the mask again from a generator set to that state (and the same global
rows).  Its gradient is the one autograd takes through the default path's
``where`` and division, so losses and gradients are bit for bit the
default path's; what changes is the bytes saved for backward.  The JAX
package keeps it off by default; so does the port.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from gesturediffusion_tpu_torch.parallel.distributed import current_rows, draw_rows, using_rows


def _keep_mask(shape, dtype, device, keep_prob: float,
               generator: torch.Generator) -> torch.Tensor:
    return draw_rows(shape, lambda s: torch.empty(s, dtype=dtype, device=device).bernoulli_(
        keep_prob, generator=generator)).bool()


class SeedDropout(torch.autograd.Function):
    """where(mask, x / keep_prob, 0) that saves the generator's state, not
    the mask, and draws the mask again in backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, rate: float, generator: torch.Generator):
        keep_prob = 1.0 - rate
        ctx.state, ctx.rows = generator.get_state(), current_rows()
        ctx.keep_prob, ctx.meta = keep_prob, (x.shape, x.dtype, x.device, generator.device)
        keep = _keep_mask(x.shape, x.dtype, x.device, keep_prob, generator)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        shape, dtype, device, gen_device = ctx.meta
        generator = torch.Generator(device=gen_device)
        generator.set_state(ctx.state)
        with using_rows(ctx.rows):
            keep = _keep_mask(shape, dtype, device, ctx.keep_prob, generator)
        # autograd's gradient through the default path: where's, then the division's
        dx = torch.where(keep, grad, torch.zeros((), dtype=grad.dtype, device=grad.device))
        return dx / ctx.keep_prob, None, None


def seed_dropout_enabled() -> bool:
    """``GDT_SEED_DROPOUT=1`` in the environment now."""
    return os.environ.get("GDT_SEED_DROPOUT", "0") == "1"


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """where(bernoulli(1 - rate), x / (1 - rate), 0); rate 0 returns x
    and draws nothing.  The generator lives on x's device."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training dropout needs an explicit torch.Generator")
    if torch.is_grad_enabled() and x.requires_grad and seed_dropout_enabled():
        return SeedDropout.apply(x, rate, generator)
    keep_prob = 1.0 - rate
    keep = _keep_mask(x.shape, x.dtype, x.device, keep_prob, generator)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
