"""Transformer encoder with torch ``nn.TransformerEncoderLayer`` semantics,
inference only.

PyTorch counterpart of gesturediffusion_tpu/models/transformer.py
(MultiheadSelfAttention, TransformerEncoderLayer, TransformerEncoder; the
fused inference layer FusedTransformerEncoderLayer is the same function).
Post-LN order, GELU in its tanh form, batch-major [B, T, D].  Parameter
names follow the reference state dict: ``layers.{i}.self_attn.
in_proj_weight``, ``self_attn.out_proj``, ``linear1``, ``linear2``,
``norm1``, ``norm2``.

GELU only (the activation of every configuration the repo ships).  Each
layer is one call of ops/fused_encoder.py:fused_encoder_layer, which
launches the CUDA kernel for CUDA tensors and runs the plain layer for CPU
tensors; ``use_kernels=False`` runs the plain layer on any device (the
card-side reference the kernel is held against).  Dropout and the
training layers wait for the training port.
"""

from __future__ import annotations

import torch
from torch import nn

from gesturediffusion_tpu_torch.ops.fused_encoder import (
    encoder_layer_plain,
    fused_encoder_layer,
)


class MultiheadSelfAttention(nn.Module):
    """Packed-QKV self-attention parameters in nn.MultiheadAttention's
    layout; the layer's kernel (or plain version) computes with them."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.num_heads = num_heads
        self.self_attn = MultiheadSelfAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def weights(self) -> tuple[torch.Tensor, ...]:
        """The layer's 12 tensors in fused_encoder_layer's argument order."""
        a = self.self_attn
        return (
            a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
            self.norm1.weight, self.norm1.bias,
            self.linear1.weight, self.linear1.bias,
            self.linear2.weight, self.linear2.bias,
            self.norm2.weight, self.norm2.bias,
        )

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        layer = fused_encoder_layer if use_kernels else encoder_layer_plain
        return layer(x, *self.weights(), num_heads=self.num_heads)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, use_kernels)
        return x
