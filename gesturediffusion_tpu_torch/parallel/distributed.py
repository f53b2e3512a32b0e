"""The ranks of one run over torch.distributed.

Counterpart of gesturediffusion_tpu/parallel/distributed.py (:38-93).  JAX
runs one program over a mesh of devices and GSPMD places its collectives;
the port runs one process a card (a rank) and makes its collectives itself:

  * ``maybe_initialize`` joins the process group the environment names
    (GDT_COORDINATOR_ADDRESS as host:port, GDT_NUM_PROCESSES,
    GDT_PROCESS_ID) over TCP: NCCL for ranks on the card, gloo on the CPU.
    Where the launcher knows the topology the GDT_* pair may be left out,
    as JAX's runtime lets it be (distributed.py:36-53): under torchrun the
    world size and the rank come from WORLD_SIZE and RANK.
    GDT_DIST_BACKEND=gloo forces gloo, which lets two ranks share one card
    (NCCL refuses that).  Without GDT_COORDINATOR_ADDRESS it does nothing;
  * ``rank_device``: a rank takes the card torchrun's LOCAL_RANK names
    where it is set, else card rank % device_count (either modulo the
    cards), unless the device names its index;
  * every rank builds the same shuffled order and loads only its contiguous
    slice of each global batch (``local_batch_slice``, data/loader.py);
    ``make_global_batch`` gathers the slices back in rank order;
  * ``global_rows`` says which rows of the global batch this rank holds
    while a step or a take runs.  Every random draw on the way (timesteps,
    noise, dropout and conditioning masks, the samplers' noise) is then
    drawn for the whole batch from the generator all ranks seed alike, and
    the rank keeps its rows (``draw_rows``): the draws of the
    single-process run, as GSPMD draws over the global batch.  The training
    layer's hash dropout indexes from the rows' offset, and the wav
    encoder's BatchNorm sums its statistics over ``group``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from gesturediffusion_tpu_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")


WORLD_PAIRS = (("GDT_NUM_PROCESSES", "GDT_PROCESS_ID"), ("WORLD_SIZE", "RANK"))
_BOTH = ("a rank needs the world size and its rank: GDT_NUM_PROCESSES and GDT_PROCESS_ID, "
         "or torchrun's WORLD_SIZE and RANK")


def world_from_env() -> tuple[int, int]:
    """(world size, rank) from GDT_NUM_PROCESSES and GDT_PROCESS_ID, or,
    where that pair is unset, from torchrun's WORLD_SIZE and RANK.  Half a
    pair, neither pair, or two pairs that disagree raise a ValueError
    naming both sources."""
    pairs = []
    for names in WORLD_PAIRS:
        values = [os.environ.get(n) or None for n in names]
        if (values[0] is None) != (values[1] is None):
            raise ValueError(f"GDT_COORDINATOR_ADDRESS is set but {names[values.index(None)]} "
                             f"is not (only {names[values[0] is None]} is): {_BOTH}")
        pairs.append(None if values[0] is None else (int(values[0]), int(values[1])))
    gdt, run = pairs
    if gdt is None and run is None:
        raise ValueError(f"GDT_COORDINATOR_ADDRESS is set but neither GDT_NUM_PROCESSES nor "
                         f"WORLD_SIZE is: {_BOTH}")
    if gdt is not None and run is not None and gdt != run:
        raise ValueError(f"GDT_NUM_PROCESSES / GDT_PROCESS_ID {gdt} disagree with torchrun's "
                         f"WORLD_SIZE / RANK {run}: {_BOTH}, not two different worlds")
    return gdt or run


def maybe_initialize(device=None) -> bool:
    """Join the process group named by GDT_COORDINATOR_ADDRESS and the
    world of ``world_from_env`` (GDT_NUM_PROCESSES and GDT_PROCESS_ID, or
    torchrun's WORLD_SIZE and RANK), on the backend of this rank's device
    (``rank_device(device)``) unless GDT_DIST_BACKEND names one.  Returns
    True if a group was joined (or already was).  A rank that cannot reach
    its card or its peers raises the init's error."""
    addr = os.environ.get("GDT_COORDINATOR_ADDRESS")
    if not addr:
        return False
    if dist.is_initialized():
        return True
    world, rank = world_from_env()
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} out of range")
    dev = rank_device(device, rank=rank, world=world)
    backend = os.environ.get("GDT_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"GDT_DIST_BACKEND={backend!r}: expected one of {BACKENDS}")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None, rank: Optional[int] = None,
                world: Optional[int] = None) -> torch.device:
    """``resolve_device(device)``; in a run of several ranks a card without
    an index becomes card LOCAL_RANK (torchrun's) where it is set, else
    card ``rank``, either modulo ``torch.cuda.device_count()`` (ranks that
    share a card over gloo take the same one)."""
    dev = resolve_device(device)
    world = process_count() if world is None else world
    if dev.type == "cuda" and dev.index is None and world > 1:
        local = os.environ.get("LOCAL_RANK")
        if local:
            index = int(local)
        else:
            index = process_index() if rank is None else rank
        dev = torch.device("cuda", index % torch.cuda.device_count())
    return dev


def local_batch_slice(global_batch: int, num_processes: int, process_id: int) -> slice:
    """The contiguous slice of a global batch owned by ``process_id``."""
    if global_batch % num_processes != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{num_processes} processes"
        )
    per = global_batch // num_processes
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range")
    return slice(process_id * per, (process_id + 1) * per)


def barrier() -> None:
    """Wait for every rank of the world (nothing in a one-process run)."""
    if dist.is_initialized():
        dist.barrier()


# ---- collectives over a group; ``group=None`` is a group of one rank ------ #

def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Each rank's ``x`` concatenated along ``dim`` in the group's rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group (a new tensor)."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient is summed over it too (each rank
    holds the gradient of its own loss terms)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group."""
    return x if group is None else _AllReduceSum.apply(x, group)


def make_global_batch(mesh, local):
    """The global batch from each data rank's rows: a tensor, or a dict of
    them, gathered over the mesh's data group in rank order (the
    counterpart of jax.make_array_from_process_local_data)."""
    if isinstance(local, dict):
        return {k: make_global_batch(mesh, v) for k, v in local.items()}
    return all_gather_cat(torch.as_tensor(local), mesh.data_group)


# ---- the rows of the global batch this rank holds -------------------------- #

@dataclasses.dataclass(frozen=True)
class GlobalRows:
    """Rows [start, start + count) of a global batch of ``total`` rows;
    ``group`` holds the ranks with the other rows (None: no statistic is
    reduced over ranks)."""

    start: int
    count: int
    total: int
    group: object = None


_ROWS: contextvars.ContextVar[Optional[GlobalRows]] = contextvars.ContextVar(
    "gdt_global_rows", default=None)


def current_rows() -> Optional[GlobalRows]:
    return _ROWS.get()


@contextlib.contextmanager
def using_rows(rows: Optional[GlobalRows]):
    """Run the block with ``rows`` (None: the whole batch is local)."""
    token = _ROWS.set(rows)
    try:
        yield rows
    finally:
        _ROWS.reset(token)


def global_rows(start: int, count: int, total: int, group=None):
    """``using_rows(GlobalRows(start, count, total, group))``."""
    return using_rows(GlobalRows(start, count, total, group))


def row_offset() -> int:
    """The first global row of the local batch (0 outside global_rows)."""
    rows = current_rows()
    return 0 if rows is None else rows.start


def draw_rows(shape, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """``draw(shape)`` for the local rows.  Under ``global_rows`` the
    leading axis is batch-major over ``count`` local rows (``shape[0]`` a
    multiple of it, as [B * H, ...] is): the global tensor is drawn and this
    rank's block of it kept, so every rank takes the single-process draw."""
    rows = current_rows()
    shape = tuple(shape)
    if rows is None:
        return draw(shape)
    if shape[0] % rows.count:
        raise ValueError(f"a draw of leading axis {shape[0]} over {rows.count} local rows")
    per = shape[0] // rows.count
    full = draw((rows.total * per,) + shape[1:])
    return full[rows.start * per:(rows.start + rows.count) * per]
