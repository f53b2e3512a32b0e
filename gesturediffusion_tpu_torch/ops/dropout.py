"""Dropout drawn from an explicit torch.Generator.

``F.dropout`` takes no generator, so the port draws its Bernoulli masks
itself.  Semantics of flax ``nn.Dropout`` (the JAX package's training
dropout): keep each element with probability 1 - rate and scale the kept
ones by 1 / (1 - rate).  Under parallel/distributed.py:global_rows the mask
is drawn for the global batch and this rank keeps its rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from gesturediffusion_tpu_torch.parallel.distributed import draw_rows


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """where(bernoulli(1 - rate), x / (1 - rate), 0); rate 0 returns x
    and draws nothing.  The generator lives on x's device."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training dropout needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    keep = draw_rows(x.shape, lambda shape: torch.empty(
        shape, dtype=x.dtype, device=x.device).bernoulli_(keep_prob, generator=generator)).bool()
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
