"""Causal windowed (banded) attention: windowed and dense formulations.

PyTorch counterpart of gesturediffusion_tpu/ops/local_attention.py.
``local_attention`` is the windowed form (window reshape + ``look_around``
key gathering, :27-123): each window of queries sees its own keys and those
of ``look_backward`` previous / ``look_forward`` next windows, O(T·w) work;
it is the plain version of the band kernel (ops/band_attention.py) and the
path the JAX package takes above 256 frames off the TPU.
``local_attention_dense`` is one [T, T] score matrix with a static band
mask, the path at the gesture shapes (T <= 256).  Both take [B, H, T, D],
compute scores and softmax in float32, mask with the finite MASK_VALUE and
drop attention probabilities in training with masks from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gesturediffusion_tpu_torch.ops.dropout import dropout

MASK_VALUE = -torch.finfo(torch.float32).max


def look_around(x: torch.Tensor, backward: int = 1, forward: int = 0,
                pad_value: float = -1.0) -> torch.Tensor:
    """Concatenate each window with its ``backward`` predecessors and
    ``forward`` successors (local_attention.py:27): x [B, W, N, *rest] ->
    [B, W, (backward + 1 + forward) * N, *rest]; windows off either end
    are filled with ``pad_value``."""
    w = x.shape[1]
    pad = [0, 0] * (x.dim() - 2) + [backward, forward]
    padded = F.pad(x, pad, value=pad_value)
    return torch.cat([padded[:, i:i + w] for i in range(backward + forward + 1)], dim=2)


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    causal: bool = True,
    look_backward: int = 1,
    look_forward: int = 0,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    exact_windowsize: bool = False,
) -> torch.Tensor:
    """Banded attention over fixed windows (local_attention.py:45).  T must
    be divisible by ``window_size``; ``mask`` [B, T] marks valid keys.
    Keys of the padded windows carry index -1 and are masked."""
    if causal and look_forward > 0:
        raise ValueError("cannot look forward with causal attention")
    b, h, t, d = q.shape
    if t % window_size != 0:
        raise ValueError(
            f"sequence length {t} must be divisible by window size {window_size}"
        )
    windows = t // window_size

    def to_windows(x):
        return x.reshape(b * h, windows, window_size, d)

    bq = to_windows(q.float())
    bk = look_around(to_windows(k.float()), look_backward, look_forward, 0.0)
    bv = look_around(to_windows(v), look_backward, look_forward, 0.0)
    seq = torch.arange(t, device=q.device).reshape(1, windows, window_size)
    bq_t = seq[..., :, None]                                              # [1, W, N, 1]
    bq_k = look_around(seq, look_backward, look_forward, -1)[..., None, :]  # [1, W, 1, N']

    sim = torch.einsum("bwie,bwje->bwij", bq, bk) * (d**-0.5)
    band = bq_k < 0
    if causal:
        band = band | (bq_t < bq_k)
        if exact_windowsize:
            band = band | (bq_t > bq_k + window_size * look_backward)
    sim = sim.masked_fill(band, MASK_VALUE)
    if mask is not None:
        km = mask.reshape(b, windows, window_size).to(torch.int32)
        km = look_around(km, look_backward, look_forward, 0) > 0
        sim = sim.reshape(b, h, windows, window_size, -1)
        sim = sim.masked_fill(~km[:, None, :, None, :], MASK_VALUE)
        sim = sim.reshape(b * h, windows, window_size, -1)
    attn = dropout(sim.softmax(dim=-1).to(v.dtype), dropout_rate, generator)
    return torch.einsum("bwij,bwje->bwie", attn, bv).reshape(b, h, t, d)


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
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Banded attention: query i sees key j when their windows are at
    most ``look_backward`` apart backwards and ``look_forward`` forwards
    (and j <= i when causal).  ``mask`` [B, T] marks valid keys.  Scores
    and softmax in float32; masked scores take the finite MASK_VALUE.
    ``dropout_rate`` > 0 drops probabilities with masks from ``generator``
    (local_attention.py:174-176)."""
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
    attn = dropout(sim.softmax(dim=-1).to(v.dtype), dropout_rate, generator)
    return torch.einsum("bhij,bhjd->bhid", attn, v)
