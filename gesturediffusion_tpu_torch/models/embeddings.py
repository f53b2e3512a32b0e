"""Timestep embedding, rotary position encoding and conditioning masks.

PyTorch counterpart of gesturediffusion_tpu/models/embeddings.py.  The
rotary convention is the half-split variant: the feature dim is split in
two halves, frequencies are duplicated across them, and rotate_half maps
(x1, x2) -> (-x2, x1).  Module and buffer names follow the reference torch
state dict (``embed_timestep.time_embed.{0,2}``,
``sequence_pos_encoder.pe``, ``rel_pos.inv_freq``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from gesturediffusion_tpu_torch.ops.dropout import dropout as drop
from gesturediffusion_tpu_torch.parallel.distributed import draw_rows
from gesturediffusion_tpu_torch.parallel.tensor import Linear


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Sin/cos table [max_len, d_model] in float64 (sin on even columns,
    cos on odd).  Counterpart of embeddings.py:sinusoidal_table."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Holds the reference's ``pe`` buffer [max_len, 1, d_model] (float32).
    The gesture denoiser reads it only through TimestepEmbedder; MotionMDM
    adds it to its [B, T, D] sequence, with dropout at ``dropout`` in
    training, the mask drawn from the caller's generator
    (embeddings.py:PositionalEncoding)."""

    def __init__(self, d_model: int, max_len: int = 5000, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        pe = sinusoidal_table(max_len, d_model).astype(np.float32)
        self.register_buffer("pe", torch.from_numpy(pe[:, None, :]))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.pe[:x.shape[1], 0].to(x.dtype)
        return drop(x, self.dropout, generator) if train else x


class TimestepEmbedder(nn.Module):
    """t -> PE-table lookup -> Linear -> SiLU -> Linear, output [B, D].
    Counterpart of embeddings.py:TimestepEmbedder."""

    def __init__(self, latent_dim: int, sequence_pos_encoder: PositionalEncoding):
        super().__init__()
        self.sequence_pos_encoder = sequence_pos_encoder
        self.time_embed = nn.Sequential(
            Linear(latent_dim, latent_dim),
            nn.SiLU(),
            Linear(latent_dim, latent_dim),
        )

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        h = self.sequence_pos_encoder.pe[timesteps.long(), 0]
        return self.time_embed(h)


class RotaryInvFreq(nn.Module):
    """Holds the reference's ``rel_pos.inv_freq`` buffer [dim_head / 2] so
    checkpoints round-trip; the rotary tables are built by rotary_freqs."""

    def __init__(self, dim_head: int):
        super().__init__()
        inv = 1.0 / (10000 ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
        self.register_buffer("inv_freq", torch.from_numpy(inv.astype(np.float32)))


def rotary_freqs(seq_len: int, dim_head: int, device=None) -> torch.Tensor:
    """RoPE frequency table [seq_len, dim_head] (duplicated halves), built
    in float64 and cast to float32.  Counterpart of
    embeddings.py:rotary_freqs."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    freqs = np.einsum("i,j->ij", np.arange(seq_len, dtype=np.float64), inv_freq)
    table = np.concatenate([freqs, freqs], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) -> (-x2, x1) on the split-in-half last dim."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, freqs: torch.Tensor):
    """Rotate q and k by position; freqs [T, D] broadcasts over leading
    dims.  Counterpart of embeddings.py:apply_rotary_pos_emb."""
    cos, sin = freqs.cos(), freqs.sin()
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def mask_cond(
    cond2d: torch.Tensor,
    uncond: torch.Tensor,
    cond_mask_prob: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Zero the conditioning rows [B, C] where ``uncond`` [B] is set (the
    CFG unconditional branch) and, in training, rows drawn with probability
    ``cond_mask_prob`` from ``generator`` (embeddings.py:mask_cond), drawn
    for the global batch under parallel/distributed.py:global_rows."""
    out = cond2d * (1.0 - uncond.to(cond2d.dtype))[:, None]
    if train and cond_mask_prob > 0.0:
        if generator is None:
            raise ValueError("training conditioning dropout needs a torch.Generator")
        bern = draw_rows((cond2d.shape[0], 1), lambda shape: torch.empty(
            shape, dtype=cond2d.dtype, device=cond2d.device).bernoulli_(
                cond_mask_prob, generator=generator))
        out = out * (1.0 - bern)
    return out
