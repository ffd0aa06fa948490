"""The data-parallel world: PyTorch's idiom for the JAX device mesh.

Counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``. The JAX
package lays its chips on a mesh whose ``data`` axis carries batch
sharding and the gradient all-reduce. Here one process is one rank is one
device, and the ``data`` axis is the default ``torch.distributed``
process group: :func:`make_mesh` returns a :class:`World` (the group, this
rank, the group's size and the rank's device). Without an initialized
group it is a world of one rank whose collectives are no-ops.

The backend follows from the layout (:func:`choose_backend`): NCCL when
each rank of a host has a card of its own, gloo otherwise (the CPU, and
several ranks sharing one card, which NCCL refuses). Every collective of
the port is an ``all_reduce``, which gloo also takes on CUDA tensors (as it
takes ``broadcast``, but not ``all_gather`` or ``reduce_scatter``), so one
code path serves gloo on the CPU, gloo on CUDA tensors and NCCL.

The JAX shardings ``replicated`` / ``batch_sharded`` /
``stacked_per_device`` become which rows of a global array a rank keeps.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.device import resolve_device


class World(NamedTuple):
    """One rank's view of the data-parallel group."""

    group: Any  # the process group, or None for a world of one rank
    rank: int
    size: int
    device: torch.device
    backend: str | None  # "nccl" | "gloo" | None (no group)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks, in place (``op`` sum, max or
        min); a no-op without a group."""
        if self.group is not None:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def mean_(self, tensors) -> list:
        """The mean over the ranks of each tensor of ``tensors`` (float),
        as new tensors, through ONE all-reduce of a flat bucket."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        flat = flatten(tensors)
        self.all_reduce_(flat)
        flat /= self.size
        return unflatten(flat, tensors)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def flatten(tensors) -> torch.Tensor:
    """One flat f32-or-native bucket of ``tensors`` (all of one dtype)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat: torch.Tensor, like) -> list:
    """Split ``flat`` back into tensors shaped as ``like``."""
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at : at + n].view(t.shape))
        at += n
    return out


def local_rank(rank: int) -> int:
    """This process's index on its host: ``LOCAL_RANK`` when a launcher
    set it, else the global rank (every rank on one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(device=None, rank: int = 0) -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)`` for ``None``
    or ``"cuda"``, the device as given otherwise (``"cpu"`` when the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, world_size: int) -> str:
    """NCCL when each rank of a host has a card of its own, gloo
    otherwise. The ranks of a host are ``LOCAL_WORLD_SIZE`` when a launcher
    set it, else the whole world."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_world(
    init_method: str,
    world_size: int,
    rank: int,
    *,
    device=None,
    timeout_s: float = 120.0,
) -> World:
    """Join the default process group at ``init_method`` (``tcp://host:port``
    or ``file://path``) as ``rank`` of ``world_size``, with the backend
    :func:`choose_backend` gives for this rank's device, and return the
    world. Raises if the group cannot be joined within ``timeout_s``."""
    dev = rank_device(device, rank)
    backend = choose_backend(dev, world_size)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    return make_mesh(device=dev)


def make_mesh(device=None) -> World:
    """The training world: the default process group when one is
    initialized (this rank, its size, its backend), else one rank with no
    group. ``device`` as :func:`rank_device` takes it."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        return World(dist.group.WORLD, rank, dist.get_world_size(),
                     rank_device(device, rank), dist.get_backend())
    return World(None, 0, 1, rank_device(device, 0), None)


def replicated(world: World) -> slice:
    """Rows a rank keeps of a replicated array: all of them."""
    return slice(None)


def batch_sharded(world: World, rows: int) -> slice:
    """Rows a rank keeps of a batch split over the ranks (JAX
    ``P("data")``): the ``rank``-th of ``size`` equal blocks."""
    if rows % world.size:
        raise ValueError(f"a batch of {rows} rows does not split over {world.size} ranks")
    b = rows // world.size
    return slice(world.rank * b, (world.rank + 1) * b)


def stacked_per_device(world: World) -> slice:
    """Rows a rank keeps of a per-rank stack (async copies): its own."""
    return slice(world.rank, world.rank + 1)
