"""Products on the tensor-parallel weight blocks.

Under ``--mesh_model_axis N`` JAX places each weight of
parallel/mesh.py:shard_params_tp as a column block of its [in, out]
kernel (train/loop.py:_place_state) and GSPMD runs every product on the
blocks, placing the collectives itself.  The port holds the same blocks:
a picked parameter of the model *is* its row block of torch's [out, in]
(``Block`` rides on it as ``tp_block``), and its consumers call the
functions here, which route a block through the collectives over the
mesh's model group and a whole weight through plain PyTorch, so that
without a mesh nothing changes:

  * ``linear`` (and the ``Linear`` module) is the column-parallel product
    ``ColumnParallelLinear``: y = all_gather_last(x @ W_blk^T + b_blk), the
    blocks in model-rank order and the bias replicated (JAX keeps 1-D
    biases replicated); backward dW_blk = g_blk^T x, db from the whole g,
    and dx = the sum over the model group of g_blk @ W_blk;
  * ``whole`` gathers a block whole under autograd (the gradient of the
    whole weight back to the block is its slice): for a consumer that
    takes whole weights, as a pallas_call under GSPMD has its operands
    gathered.

A failed collective raises; there is no quiet return to whole weights.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gesturediffusion_tpu_torch.parallel.distributed import all_gather_cat


@dataclasses.dataclass(frozen=True)
class Block:
    """A parameter that holds row block ``index`` of ``size`` equal row
    blocks of a whole weight; ``group`` is the mesh's model group."""

    group: object
    index: int
    size: int

    def of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row block of the whole tensor ``t`` (a view)."""
        n = t.shape[0] // self.size
        return t[self.index * n:(self.index + 1) * n]


def block_of(w: torch.Tensor):
    """The ``Block`` a parameter holds, or None for a whole weight."""
    return getattr(w, "tp_block", None)


class ColumnParallelLinear(torch.autograd.Function):
    """x [..., in] @ W_blk^T + b_blk gathered along the last axis over
    ``group`` in rank order: x @ W^T + b of the whole W [out, in] from its
    row blocks.  The bias is replicated; each rank adds its block's slice
    inside its product, as F.linear adds a bias, so that a block's columns
    are those of the whole product bit for bit (a bias added after the
    gather rounds differently once the product's sum over ``in`` is split
    in blocks).  Every rank of the group holds the whole output gradient,
    so each takes the whole bias gradient from it."""

    @staticmethod
    def forward(ctx, x, w_blk, b, group):
        n = w_blk.shape[0]
        b_blk = None if b is None else b.narrow(0, dist.get_rank(group) * n, n)
        ctx.group = group
        ctx.save_for_backward(x, w_blk)
        return all_gather_cat(F.linear(x, w_blk, b_blk), group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, w_blk = ctx.saved_tensors
        n = w_blk.shape[0]
        g_blk = g.narrow(-1, dist.get_rank(ctx.group) * n, n)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = g_blk.matmul(w_blk)
            dist.all_reduce(dx, group=ctx.group)
        if ctx.needs_input_grad[1]:
            dw = g_blk.reshape(-1, n).t().matmul(x.reshape(-1, x.shape[-1]))
        if ctx.needs_input_grad[2]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, dw, db, None


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``F.linear(x, w, b)``; a block of a weight runs the column-parallel
    product over its model group."""
    blk = block_of(w)
    if blk is None:
        return F.linear(x, w, b)
    return ColumnParallelLinear.apply(x, w, b, blk.group)


class Linear(nn.Linear):
    """nn.Linear whose weight may be a tensor-parallel block (``linear``);
    the same parameters, initialisation and, whole, the same product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class _GatherBlock(torch.autograd.Function):
    """The whole tensor from every rank's row block; the gradient of the
    whole back to this rank's block is its slice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        return all_gather_cat(t, group)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g.narrow(0, dist.get_rank(ctx.group) * n, n).contiguous(), None


def whole(w: torch.Tensor) -> torch.Tensor:
    """The whole weight of a block (gathered, differentiably); a whole
    weight as it is."""
    blk = block_of(w)
    return w if blk is None else _GatherBlock.apply(w, blk.group)

