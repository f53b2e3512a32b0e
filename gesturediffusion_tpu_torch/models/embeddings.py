"""Timestep embedding, rotary position encoding and conditioning masks.

PyTorch counterpart of gesturediffusion_tpu/models/embeddings.py.  The
rotary convention is the half-split variant: the feature dim is split in
two halves, frequencies are duplicated across them, and rotate_half maps
(x1, x2) -> (-x2, x1).  Module and buffer names follow the reference torch
state dict (``embed_timestep.time_embed.{0,2}``,
``sequence_pos_encoder.pe``, ``rel_pos.inv_freq``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
    The gesture denoiser reads it only through TimestepEmbedder."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        pe = sinusoidal_table(max_len, d_model).astype(np.float32)
        self.register_buffer("pe", torch.from_numpy(pe[:, None, :]))


class TimestepEmbedder(nn.Module):
    """t -> PE-table lookup -> Linear -> SiLU -> Linear, output [B, D].
    Counterpart of embeddings.py:TimestepEmbedder."""

    def __init__(self, latent_dim: int, sequence_pos_encoder: PositionalEncoding):
        super().__init__()
        self.sequence_pos_encoder = sequence_pos_encoder
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim),
            nn.SiLU(),
            nn.Linear(latent_dim, latent_dim),
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


def mask_cond(cond2d: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
    """Zero the conditioning rows [B, C] where ``uncond`` [B] is set (the
    CFG unconditional branch).  Inference only: the random training
    dropout of embeddings.py:mask_cond waits for the training port."""
    return cond2d * (1.0 - uncond.to(cond2d.dtype))[:, None]
