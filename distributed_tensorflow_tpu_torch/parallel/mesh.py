"""The mesh of ranks: PyTorch's idiom for the JAX device mesh.

Counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``. The JAX
package lays its chips on a mesh with named axes, ``("data", "model")`` by
default: ``data`` carries batch sharding and the gradient all-reduce,
``model`` the tensor-parallel layout. Here one process is one rank is one
device. :func:`make_mesh` lays the ranks of the default
``torch.distributed`` process group row-major on a grid of named axes (by
default every rank on ``data`` and ``model`` of size 1, as JAX's) and
returns a :class:`Mesh`: this rank, its coordinates, its device and one
sub-group (``dist.new_group``) for each set of ranks that differ along a
set of axes. Without an initialized group it is a mesh of one rank whose
collectives are no-ops.

The backend follows from the layout (:func:`choose_backend`): NCCL when
each rank of a host has a card of its own, gloo otherwise (the CPU, and
several ranks sharing one card, which NCCL refuses). The data-parallel
strategies' collectives are ``all_reduce`` and ``broadcast``, which gloo
also takes on CUDA tensors, so one code path serves gloo on the CPU, gloo
on CUDA tensors and NCCL.

The JAX shardings ``replicated`` / ``batch_sharded`` /
``stacked_per_device`` become which rows of a global array a rank keeps
(its index along ``data``).

The mesh's collectives take axis names as the JAX ones do (``lax.axis_size``
/ ``lax.axis_index``): ``all_reduce_`` and ``mean_`` over one or several
axes (every axis by default), :meth:`Mesh.ring_permute` (the JAX
``lax.ppermute`` with the ring's permutation, differentiable: its backward
is the inverse permute) and :meth:`Mesh.all_to_all` (``lax.all_to_all``,
differentiable the same way). The permute runs on ``dist.batch_isend_irecv``
to the partners' global ranks. gloo cannot send a CUDA tensor point to
point (the send fails in ``writev`` with a bad address), so under gloo a
hop stages its buffer through host memory (ranks that share one card);
gloo's ``all_to_all_single`` takes CUDA tensors, and under NCCL both stay
on the device. The tensor-parallel collectives over an axis are
``ops/collectives.py``'s.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.device import resolve_device


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
) -> Mesh:
    """Join the default process group at ``init_method`` (``tcp://host:port``
    or ``file://path``) as ``rank`` of ``world_size``, with the backend
    :func:`choose_backend` gives for this rank's device, and return the
    default mesh (:func:`make_mesh`: every rank on ``data``). Raises if the
    group cannot be joined within ``timeout_s``."""
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


def replicated(mesh: Mesh) -> slice:
    """Rows a rank keeps of a replicated array: all of them."""
    return slice(None)


def batch_sharded(mesh: Mesh, rows: int, axis: str = "data") -> slice:
    """Rows a rank keeps of a batch split over ``axis`` (JAX ``P("data")``):
    the block of its index along the axis, of the axis size's equal
    blocks."""
    n = mesh.axis_size(axis)
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} ranks")
    b, i = rows // n, mesh.axis_index(axis)
    return slice(i * b, (i + 1) * b)


def stacked_per_device(mesh: Mesh, axis: str = "data") -> slice:
    """Rows a rank keeps of a per-rank stack (async copies): its own."""
    i = mesh.axis_index(axis)
    return slice(i, i + 1)


class Mesh:
    """This rank's view of a grid of ranks with named axes (the JAX
    ``jax.sharding.Mesh``). ``shape`` maps each axis name to its size, in
    order; ``coords[name]`` is this rank's index along it
    (``lax.axis_index``). A rank's coordinates are its global rank
    unravelled row-major over the shape, the order of the JAX mesh's
    device grid. Made by :func:`make_mesh`; built directly with no
    ``groups``, it is a layout only (every collective a no-op), which is
    what a mesh of one rank is."""

    def __init__(self, shape: dict, rank: int = 0, device=None, backend=None,
                 groups: dict | None = None, coords: dict | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank  # the global rank
        self.size = math.prod(self.shape.values())
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.backend = backend
        # frozenset of axes -> (group or None, global ranks ordered by their
        # index along those axes)
        self._groups = groups or {}
        self.coords = coords or dict(zip(self.axis_names, _unravel(rank, self.shape)))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (one axis, or several taken
        row-major in mesh order)."""
        idx = 0
        for a in self.axis_names:
            if a in _axes(axes):
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The sub-group of the ranks that differ from this one only along
        ``axes``, and their global ranks in order (the group None for a set
        of one rank, and on a layout-only mesh)."""
        axes = frozenset(_axes(axes))
        unknown = axes - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh has no axis {sorted(unknown)}: {self.shape}")
        if axes in self._groups:
            return self._groups[axes]
        members = [r for r in range(self.size)
                   if all(c == self.coords[a] for a, c in
                          zip(self.axis_names, _unravel(r, self.shape)) if a not in axes)]
        return None, members

    def all_reduce_(self, t: torch.Tensor, axes=None, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axes`` (every axis for None) in place, ``op``
        sum, max or min; a no-op for one rank."""
        g, _ = self.group(self.axis_names if axes is None else axes)
        if g is not None:
            dist.all_reduce(t, op=_OPS[op], group=g)
        return t

    def mean_(self, tensors, axes=None) -> list:
        """The mean over ``axes`` (every axis for None) of each tensor of
        ``tensors`` (float), as new tensors, through ONE all-reduce of a
        flat bucket."""
        tensors = list(tensors)
        n = self.axis_size(self.axis_names if axes is None else axes)
        if n == 1:
            return tensors
        flat = flatten(tensors)
        self.all_reduce_(flat, axes)
        flat /= n
        return unflatten(flat, tensors)

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The mean of ``x`` over ``axes`` (``lax.pmean``), differentiable
        for a result every rank then uses alike: each rank's ``x`` takes
        1/n of the result's gradient, with no collective."""
        if self.axis_size(axes) == 1:
            return x
        return _PMean.apply(self, tuple(_axes(axes)), x)

    def ring_permute(self, tensors: Sequence[torch.Tensor], axis: str, shift: int = 1):
        """Each tensor of this rank to the rank ``shift`` steps on along
        ``axis`` (``lax.ppermute`` with ``[(j, (j + shift) % n)]``), and
        that of the rank ``shift`` steps back in its place; differentiable
        (the gradient takes the inverse permute). One send and one receive
        of a flat buffer a call."""
        tensors = tuple(tensors)
        if self.shape[axis] == 1:
            return tensors
        return _RingPermute.apply(self, axis, shift, *tensors)

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int, concat_axis: int):
        """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=False)``:
        ``x`` with ``x.shape[split_axis] == n`` sends its i-th slice along
        ``split_axis`` to rank i of ``axis`` and stacks what it receives,
        by source, as a new axis at ``concat_axis`` of the result (the
        split axis removed); differentiable (the gradient takes the inverse
        exchange)."""
        if self.shape[axis] == 1:
            return x.movedim(split_axis, concat_axis)
        return _AllToAll.apply(self, axis, split_axis, concat_axis, x)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _unravel(rank: int, shape: dict) -> list:
    out = []
    for n in reversed(list(shape.values())):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def permute_raw(mesh: Mesh, axis: str, tensors, shift: int) -> list:
    """:meth:`Mesh.ring_permute` without autograd: one flat buffer sent to
    the rank ``shift`` on and one received from the rank ``shift`` back
    (the tensors themselves on an axis of one rank)."""
    g, ranks = mesh.group(axis)
    n, i = len(ranks), mesh.coords[axis]
    if n == 1:
        return list(tensors)
    flat = flatten([t.contiguous() for t in tensors])
    if flat.is_cuda and mesh.backend == "gloo":  # gloo sends from host memory only
        flat = flat.cpu()
    out = torch.empty_like(flat)
    ops = [dist.P2POp(dist.isend, flat, ranks[(i + shift) % n], g),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = out.to(tensors[0].device)
    return [o.view_as(t) for o, t in zip(unflatten(out, tensors), tensors)]


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return tuple(permute_raw(mesh, axis, tensors, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *permute_raw(ctx.mesh, ctx.axis, grads, -ctx.shift))


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, x):
        ctx.n = mesh.axis_size(axes)
        return mesh.all_reduce_(x.detach().clone(), axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return None, None, g / ctx.n


def all_to_all_raw(mesh: Mesh, axis: str, x: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
    """:meth:`Mesh.all_to_all` without autograd (``dist.all_to_all_single``
    over the axis's group)."""
    g, _ = mesh.group(axis)
    n = mesh.shape[axis]
    if x.shape[split_axis] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks) splits an axis of size {n}, "
                         f"got {x.shape[split_axis]}")
    send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    return recv.movedim(0, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, split_axis, concat_axis, x):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return all_to_all_raw(mesh, axis, x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return None, None, None, None, all_to_all_raw(mesh, axis, g, concat_axis, split_axis)


def make_mesh(shape: Sequence[int] | dict | None = None,
              axis_names: Sequence[str] = ("data", "model"), *, device=None) -> Mesh:
    """The ranks of the default process group on a grid of ``shape`` with
    ``axis_names`` (a dict of name -> size also serves), row-major; the JAX
    ``make_mesh``. ``shape`` None puts every rank on the first axis and
    gives the others size 1. Every rank must call it, in the same order as
    any other group creation: it makes one sub-group for every set of axes
    whose ranks are more than one and fewer than the world. Without an
    initialized group it is a mesh of one rank. ``device`` as
    :func:`rank_device` takes it."""
    if dist.is_available() and dist.is_initialized():
        rank, total, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        rank, total, backend = 0, 1, None
    if shape is None:
        shape = (total,) + (1,) * (len(axis_names) - 1)
    if isinstance(shape, dict):
        shape = dict(shape)
    else:
        shape = tuple(shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axis names {tuple(axis_names)}")
        shape = dict(zip(axis_names, shape))
    if len(set(shape)) != len(shape) or any(n < 1 for n in shape.values()):
        raise ValueError(f"bad mesh shape {shape}")
    if math.prod(shape.values()) != total:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape.values())} ranks, "
                         f"the world has {total}")
    names = tuple(shape)
    coords = [_unravel(r, shape) for r in range(total)]
    groups = {}
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            members = {}
            for r in range(total):
                key = tuple(c for a, c in zip(names, coords[r]) if a not in sub)
                members.setdefault(key, []).append(r)
            mine = None
            for ranks in members.values():
                g = None
                if 1 < len(ranks) < total:
                    g = dist.new_group(ranks)  # collective: every rank makes every group
                elif len(ranks) == total > 1:
                    g = dist.group.WORLD
                if rank in ranks:
                    mine = (g, ranks)
            groups[frozenset(sub)] = mine
    return Mesh(shape, rank, rank_device(device, rank), backend, groups)

