"""Causal windowed (banded) attention, dense formulation.

PyTorch counterpart of gesturediffusion_tpu/ops/local_attention.py:
local_attention_dense — one [T, T] score matrix with a static band mask,
the path the JAX package takes at the gesture shapes (T <= 256).  The
windowed ``local_attention`` waits for a later slice.  Layout [B, H, T, D].
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -torch.finfo(torch.float32).max


def local_attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    causal: bool = True,
    look_backward: int = 1,
    look_forward: int = 0,
    mask: Optional[torch.Tensor] = None,
    exact_windowsize: bool = False,
) -> torch.Tensor:
    """Banded attention: query i sees key j when their windows are at
    most ``look_backward`` apart backwards and ``look_forward`` forwards
    (and j <= i when causal).  ``mask`` [B, T] marks valid keys.  Scores
    and softmax in float32; masked scores take the finite MASK_VALUE."""
    if causal and look_forward > 0:
        raise ValueError("cannot look forward with causal attention")
    t, d = q.shape[-2], q.shape[-1]
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * (d**-0.5)
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    wi, wj = i // window_size, j // window_size
    allowed = (wi - wj <= look_backward) & (wj - wi <= look_forward)
    if causal:
        allowed = allowed & (j <= i)
    if exact_windowsize and causal:
        allowed = allowed & (i - j <= window_size * look_backward)
    sim = sim.masked_fill(~allowed, MASK_VALUE)
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :].bool(), MASK_VALUE)
    attn = sim.softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhij,bhjd->bhid", attn, v)
