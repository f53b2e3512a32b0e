"""The (data, model) grid of ranks and the tensor-parallel rule.

Counterpart of gesturediffusion_tpu/parallel/mesh.py (:28-158).  The ranks
of the world form a grid ``np.arange(world).reshape(data, model)``,
data-major as JAX reshapes its devices:

  * ``data`` splits the batch: the ranks of one model index (this rank's
    ``data_group``) hold different rows and average their gradients;
  * ``model`` splits the large weights: the ranks of one data index (its
    ``model_group``) load the same rows, and each holds a 1/``model``
    row block of every weight ``shard_params_tp`` picks, with its
    gradient, its AdamW moments and its EMA
    (``ShardedParams``, JAX's train/loop.py:_place_state).  The products
    run on the blocks (parallel/tensor.py); a whole weight is built only
    where something reads it whole: the fused training layer (a transient
    a call, as a pallas_call under GSPMD gets its operands gathered), a
    checkpoint and the evaluation at a save (``ShardedParams.whole``).

A group of width 1 is None, and the collectives of parallel/distributed.py
skip it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gesturediffusion_tpu_torch.parallel.distributed import (
    all_gather_cat,
    all_reduce_sum,
    process_count,
    process_index,
)
from gesturediffusion_tpu_torch.parallel.tensor import Block, block_of


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
    """The weights tensor parallelism shards, by JAX's shape rule
    (mesh.py:125-158) in torch's layout: 2-D, at least ``min_size``
    elements, and an output dimension (the rows of [out, in]) divisible by
    the model width.  Returns {name: this rank's row block}; every other
    parameter is replicated."""
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
    """The tensor-parallel half of a train state.  Each weight of
    ``shard_params_tp`` becomes its block in the model itself (the
    parameter's data is cut to the block and it carries a
    parallel/tensor.py:Block), so its gradient, its AdamW moments and its
    EMA are blocks too, and its consumers run their products on the block.
    ``whole`` builds the whole weights for a block of code that reads them
    whole (a checkpoint, a load, rank 0's evaluation); the optimizer state
    and the EMA cross to and from the single-process layout a checkpoint
    keeps through ``full_optimizer_state`` / ``local_optimizer_state`` and
    ``whole_tensors`` / ``block_tensors``."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, min_size: int = 1 << 16):
        self.mesh = mesh
        self.params = dict(model.named_parameters())
        if any(block_of(p) is not None for p in self.params.values()):
            raise ValueError("the model already holds tensor-parallel blocks (another "
                             "train state's): build the state on a fresh model")
        for n, p in self.params.items():
            # JAX would shard this [num_actions, D] kernel on its columns; the
            # port reads it by rows and keeps it whole (no shipped dataset
            # has enough actions to reach the rule)
            if n.endswith("action_embedding") and p.numel() >= min_size:
                raise ValueError(f"{n} {tuple(p.shape)}: an action table of {min_size} "
                                 "elements or more is not tensor-parallel in the port")
        self.blocks = shard_params_tp(self.params.items(), mesh, min_size)
        self.block = Block(mesh.model_group, mesh.model_index, mesh.model)
        self._whole = False
        with torch.no_grad():
            for n in self.blocks:
                self._cut(n)

    def _cut(self, name: str) -> None:
        p = self.params[name]
        p.data = self.cut(p.data)
        p.tp_block = self.block

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every model rank's row block ``t``."""
        return all_gather_cat(t, self.mesh.model_group)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row block of the whole tensor ``t``."""
        return self.block.of(t).clone()

    @contextlib.contextmanager
    def whole(self, ema: Optional[dict] = None):
        """Run the block with the model's sharded weights whole, and the
        EMA ``ema`` ({name: tensor}, changed in place) too; on the way out
        each is cut back to its block of what it then holds (a load inside
        replaces the blocks).  Collective: every rank of the model group
        enters it; nested, only the outermost gathers."""
        if self._whole:
            yield
            return
        self._whole, ema = True, {} if ema is None else ema
        try:
            with torch.no_grad():
                for n in self.blocks:
                    p = self.params[n]
                    p.data = self.gather(p.data)
                    del p.tp_block
                    if n in ema:
                        ema[n] = self.gather(ema[n])
            yield
        finally:
            with torch.no_grad():
                for n in self.blocks:
                    p = self.params[n]
                    if block_of(p) is None:
                        if n in ema and ema[n].shape == p.shape:
                            ema[n] = self.cut(ema[n])
                        self._cut(n)
            self._whole = False

    def whole_tensors(self, tensors: dict) -> dict:
        """{name: tensor} with each sharded name's block gathered whole (the EMA)."""
        return {n: self.gather(t) if n in self.blocks else t for n, t in tensors.items()}

    def block_tensors(self, tensors: dict) -> dict:
        """{name: tensor} with each sharded name's whole tensor cut to its block."""
        return {n: self.cut(t) if n in self.blocks else t for n, t in tensors.items()}

    def global_norm(self, named) -> torch.Tensor:
        """sqrt of the sum of squares over (name, tensor) pairs of the whole
        model: each replicated tensor counted once, each block's squares
        summed over the model group once."""
        rep, blk = [], []
        for n, x in named:
            (blk if n in self.blocks else rep).append((x.float() ** 2).sum())
        total = torch.stack(rep).sum() if rep else None
        if blk:
            blocks = all_reduce_sum(torch.stack(blk).sum(), self.mesh.model_group)
            total = blocks if total is None else total + blocks
        return torch.sqrt(total)

    def _index(self) -> dict:
        return {i: n for i, n in enumerate(self.params) if n in self.blocks}

    def _map_moments(self, state: dict, fn) -> dict:
        state = {**state, "state": dict(state["state"])}
        for i in self._index():
            if i in state["state"]:
                state["state"][i] = {
                    k: fn(v) if torch.is_tensor(v) and v.ndim == 2 else v
                    for k, v in state["state"][i].items()}
        return state

    def full_optimizer_state(self, state: dict) -> dict:
        """An optimizer state dict with the sharded moments gathered whole:
        the single-process layout, which a checkpoint keeps."""
        return self._map_moments(state, self.gather)

    def local_optimizer_state(self, state: dict) -> dict:
        """The single-process layout cut to this rank's blocks."""
        return self._map_moments(state, self.cut)
