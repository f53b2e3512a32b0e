"""The (data, model) grid of ranks and the tensor-parallel rule.

Counterpart of gesturediffusion_tpu/parallel/mesh.py (:28-158).  The ranks
of the world form a grid ``np.arange(world).reshape(data, model)``,
data-major as JAX reshapes its devices:

  * ``data`` splits the batch: the ranks of one model index (this rank's
    ``data_group``) hold different rows and average their gradients;
  * ``model`` splits the large weights: the ranks of one data index (its
    ``model_group``) load the same rows, and each keeps a 1/``model`` row
    block of every weight ``shard_params_tp`` picks, with its AdamW
    moments (``ShardedParams``).  The step gathers the whole weights over
    the model group, because the fused layers take whole weights, as a
    pallas_call under GSPMD does.

A group of width 1 is None, and the collectives of parallel/distributed.py
skip it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gesturediffusion_tpu_torch.parallel.distributed import (
    all_gather_cat,
    process_count,
    process_index,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    data_index: int = 0
    model_index: int = 0
    data_group: object = None   # the ranks of this model index, None at width 1
    model_group: object = None  # the ranks of this data index, None at width 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


_MESHES: dict = {}


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The (data, model) grid over every rank of the world; ``data``
    defaults to the world's ranks over ``model``.  Every rank must call it
    with the same widths (the subgroups are created collectively); a grid
    is made once a process."""
    n = process_count()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} mesh != {n} ranks")
    key = (data, model)
    if key not in _MESHES:
        grid = np.arange(n).reshape(data, model)
        rank = process_index()
        (d,), (m,) = np.nonzero(grid == rank)
        data_group = model_group = None
        for j in range(model if data > 1 else 0):
            g = dist.new_group(grid[:, j].tolist())
            data_group = g if j == m else data_group
        for i in range(data if model > 1 else 0):
            g = dist.new_group(grid[i, :].tolist())
            model_group = g if i == d else model_group
        _MESHES[key] = Mesh(data, model, int(d), int(m), data_group, model_group)
    return _MESHES[key]


def make_data_mesh_for_batch(batch_size: int, model: int = 1) -> Mesh:
    """The grid over every rank with ``model`` on the model axis.  The batch
    must divide the data width: with several ranks nothing is clamped (JAX's
    multi-process rule, mesh.py:65-71), and one process is a 1 x 1 grid."""
    n = process_count()
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} devices")
    width = n // model
    if batch_size % width == 0:
        return make_mesh(data=width, model=model)
    raise ValueError(
        f"batch_size {batch_size} is not divisible by the slice's "
        f"data-parallel width {width} ({n} devices / model axis "
        f"{model}).  Multi-process meshes cannot shrink to a device "
        f"subset (a process left without devices deadlocks in "
        f"collectives) — pick a batch divisible by {width}."
    )


def shard_params_tp(named_params, mesh: Mesh, min_size: int = 1 << 16) -> dict:
    """The weights tensor parallelism shards, by JAX's shape rule in torch's
    layout: 2-D, at least ``min_size`` elements, and an output dimension
    (the rows of [out, in]) divisible by the model width.  Returns
    {name: this rank's row block}; every other parameter is replicated."""
    tp = mesh.model
    if tp == 1:
        return {}
    out = {}
    for name, p in named_params:
        if p.ndim == 2 and p.numel() >= min_size and p.shape[0] % tp == 0:
            rows = p.shape[0] // tp
            out[name] = slice(mesh.model_index * rows, (mesh.model_index + 1) * rows)
    return out


class ShardedParams:
    """The tensor-parallel half of a train step.  Each weight of
    ``shard_params_tp`` trains as its row block ``shards[name]`` (a leaf the
    optimizer owns in the weight's place, so its AdamW moments are blocks
    too); the model keeps the whole weight, which ``gather`` refills from
    the blocks after every update."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, min_size: int = 1 << 16):
        self.mesh = mesh
        self.params = dict(model.named_parameters())
        self.blocks = shard_params_tp(self.params.items(), mesh, min_size)
        self.shards = {n: self.params[n].detach()[sl].clone().requires_grad_(True)
                       for n, sl in self.blocks.items()}

    def optimizer_params(self) -> list:
        """The model's parameters in order, each sharded weight as its block."""
        return [self.shards.get(n, p) for n, p in self.params.items()]

    def refill_shards(self) -> None:
        """Blocks from the whole weights (after the model's weights load)."""
        with torch.no_grad():
            for n, sl in self.blocks.items():
                self.shards[n].copy_(self.params[n][sl])

    def keep_grad_blocks(self) -> None:
        """Each block's gradient from the whole weight's."""
        for n, sl in self.blocks.items():
            self.shards[n].grad = self.params[n].grad[sl].clone()

    def gather(self) -> None:
        """The whole weights from every model rank's block."""
        with torch.no_grad():
            for n, shard in self.shards.items():
                self.params[n].copy_(all_gather_cat(shard.detach(), self.mesh.model_group))

    def _index(self) -> dict:
        return {i: n for i, n in enumerate(self.params) if n in self.blocks}

    def full_optimizer_state(self, state: dict) -> dict:
        """An optimizer state dict with the sharded moments gathered whole:
        the single-process layout, which a checkpoint keeps."""
        state = {**state, "state": dict(state["state"])}
        for i in self._index():
            if i in state["state"]:
                state["state"][i] = {
                    k: all_gather_cat(v, self.mesh.model_group)
                    if torch.is_tensor(v) and v.ndim == 2 else v
                    for k, v in state["state"][i].items()}
        return state

    def local_optimizer_state(self, state: dict) -> dict:
        """The single-process layout cut to this rank's blocks."""
        state = {**state, "state": dict(state["state"])}
        for i, n in self._index().items():
            if i in state["state"]:
                state["state"][i] = {
                    k: v[self.blocks[n]].clone() if torch.is_tensor(v) and v.ndim == 2 else v
                    for k, v in state["state"][i].items()}
        return state
