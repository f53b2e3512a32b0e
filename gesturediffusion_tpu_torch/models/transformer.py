"""Transformer encoder with torch ``nn.TransformerEncoderLayer`` semantics.

PyTorch counterpart of gesturediffusion_tpu/models/transformer.py
(MultiheadSelfAttention, TransformerEncoderLayer, FusedTrainEncoderLayer,
TransformerEncoder; the fused inference layer FusedTransformerEncoderLayer
is the same function as the inference path here).  Post-LN order, GELU in
its tanh form, batch-major [B, T, D].  Parameter names follow the reference
state dict: ``layers.{i}.self_attn.in_proj_weight``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``; both layer classes have the
same parameters, so one checkpoint serves every path.

Inference: each layer is one call of ops/fused_encoder.py:
fused_encoder_layer (the CUDA kernel for CUDA tensors, the plain layer for
CPU tensors).  Training (``train=True``):
  * TransformerEncoderLayer runs the plain layer under autograd with
    dropout at the four sites, Bernoulli masks from the generator;
  * FusedTrainEncoderLayer draws one int32 seed per call from the
    generator and runs ops/fused_encoder_train.py: the CUDA forward and
    backward kernels for CUDA tensors, the plain hash-dropout layer for CPU
    tensors.
``use_kernels=False`` runs the plain versions on any device (the card-side
reference the kernels are held against).  GELU only (the activation of
every configuration the repo ships).

Under tensor parallelism (parallel/mesh.py:ShardedParams) a weight may be
a block: the plain layer runs its four products on the blocks
(parallel/tensor.py:linear), and the fused training layer gathers the
layer's weights for each call (ops/fused_encoder_train.py).

``remat`` (transformer.py:308-319, 370-399): each plain training layer
runs under ``torch.utils.checkpoint``, so its activations are recomputed
in the backward pass instead of kept.  The recompute replays the layer's
dropout masks: ``preserve_rng_state`` restores the global generators only,
not the explicit generator the masks come from, so the layer saves that
generator's state before its forward and the recompute draws from a copy
set to it.  The caller's generator advances once, as without remat.  As
in JAX, the fused training layer ignores it (it keeps only its input).
The recompute runs under the forward's parallel/distributed.py:global_rows
(a rank's share of the batch draws its rows of the global masks), and the
fused training layer's hash dropout counts from the share's first row.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gesturediffusion_tpu_torch.ops.dropout import dropout
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    encoder_layer_plain,
    fused_encoder_layer,
)
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    encoder_layer_train_plain,
    fused_encoder_layer_train,
)
from gesturediffusion_tpu_torch.parallel.distributed import current_rows, row_offset, using_rows

INT32_MAX = 2**31 - 1


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
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
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

    def forward(self, x: torch.Tensor, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            return self.train_forward(x, use_kernels, generator)
        layer = fused_encoder_layer if use_kernels else encoder_layer_plain
        return layer(x, *self.weights(), num_heads=self.num_heads)

    def train_forward(self, x, use_kernels, generator):
        """transformer.py:TransformerEncoderLayer with deterministic=False:
        the plain layer under autograd (the JAX package's default training
        path has no kernel either), Bernoulli dropout at the four sites."""
        rate = self.dropout
        drop = None if rate == 0.0 else (lambda z, site: dropout(z, rate, generator))
        return encoder_layer_plain(x, *self.weights(), num_heads=self.num_heads, drop=drop)


class FusedTrainEncoderLayer(TransformerEncoderLayer):
    """Training through the hash-dropout layer of
    ops/fused_encoder_train.py (transformer.py:FusedTrainEncoderLayer):
    one int32 seed drawn per call derives all four sites' masks, and the
    CUDA path saves only the layer input for backward.  Inference is the
    parent's."""

    def train_forward(self, x, use_kernels, generator):
        rate = self.dropout
        if rate > 0.0:
            if generator is None:
                raise ValueError("training dropout needs an explicit torch.Generator")
            seed = torch.randint(0, INT32_MAX, (1,), generator=generator,
                                 device=generator.device, dtype=torch.int32)
        else:
            seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
        layer = fused_encoder_layer_train if use_kernels else encoder_layer_train_plain
        return layer(x.contiguous(), *self.weights(), seed=seed,
                     num_heads=self.num_heads, rate=rate, row0=row_offset())


def rematerialised(layer: TransformerEncoderLayer, x: torch.Tensor, use_kernels: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``layer.train_forward`` under torch.utils.checkpoint, the recompute
    drawing the forward's dropout masks again from a copy of
    ``generator`` set to its state before the forward."""
    state = None if generator is None else generator.get_state()
    rows = current_rows()  # the backward may run on another thread
    calls = []

    def run(h):
        g = generator
        if calls and generator is not None:  # the recompute
            g = torch.Generator(device=generator.device)
            g.set_state(state)
        calls.append(1)
        with using_rows(rows):
            return layer.train_forward(h, use_kernels, g)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 use_fused_train_layer: bool = False, remat: bool = False):
        super().__init__()
        cls = FusedTrainEncoderLayer if use_fused_train_layer else TransformerEncoderLayer
        self.layers = nn.ModuleList(
            cls(d_model, num_heads, dim_feedforward, dropout)
            for _ in range(num_layers)
        )
        self.remat = remat and not use_fused_train_layer

    def forward(self, x: torch.Tensor, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            if train and self.remat and torch.is_grad_enabled():
                x = rematerialised(layer, x, use_kernels, generator)
            else:
                x = layer(x, use_kernels, train, generator)
        return x
