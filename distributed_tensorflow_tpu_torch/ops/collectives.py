"""Ring and tensor-parallel collectives over a mesh axis.

Counterpart of ``distributed_tensorflow_tpu/ops/collectives.py``
``ring_all_reduce`` / ``ring_all_mean`` / ``ring_all_gather`` (:69-107):
explicit ring algorithms of n − 1 neighbour hops, each hop one
:meth:`parallel.mesh.Mesh.ring_permute` (the JAX ``lax.ppermute`` with the
ring's permutation ``[(j, (j + 1) % n)]``, ``_ring_perm`` :28), the same
primitive that moves ring attention's KV blocks. They serve the async
strategy's periodic exchange (``AsyncDataParallel.make_exchange_fn(
collective="ring")``) and are differentiable, as the permute is.

The tensor-parallel collectives are Megatron's operators, which the JAX
package leaves to GSPMD: :func:`copy_to` (the identity forward, an
all-reduce backward: the input of a column-parallel product, whose
gradient each rank holds only in part), :func:`reduce_from` (an all-reduce
forward, the identity backward: the output of a row-parallel product) and
:func:`gather_from` (an all-gather forward, a reduce-scatter backward,
because every rank uses the whole gathered tensor). They share one
autograd function over three raw collectives. gloo sends no CUDA tensor
and has no reduce-scatter, so under gloo they stage through host memory
and the reduce-scatter is an all-reduce and a slice; under NCCL they stay
on the device. :class:`TensorParallel` holds the axis for a model's
forward.

Each function takes this rank's tensor, the :class:`~parallel.mesh.Mesh`
and the axis name, and is a collective: every rank of the axis calls it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ring_all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` by n − 1 neighbour hops: each hop
    forwards the chunk last received and adds it (every rank adds the
    chunks in the order they arrive, its own first)."""
    acc, cur = x, x
    for _ in range(mesh.axis_size(axis) - 1):
        (cur,) = mesh.ring_permute([cur], axis)
        acc = acc + cur
    return acc


def ring_all_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`ring_all_reduce` over the axis size."""
    return ring_all_reduce(x, mesh, axis) / mesh.axis_size(axis)


def ring_all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis [n, ...] in axis
    order, rotated around the ring: after k hops a rank holds the chunk
    that started k ranks behind it."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    parts = [None] * n
    parts[idx] = cur = x
    for k in range(n - 1):
        (cur,) = mesh.ring_permute([cur], axis)
        parts[(idx - k - 1) % n] = cur
    return torch.stack(parts)


# -- tensor parallelism -------------------------------------------------------


def _staged(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` contiguous, in host memory under gloo (which sends no CUDA
    tensor)."""
    x = x.contiguous()
    return x.cpu() if x.is_cuda and mesh.backend == "gloo" else x


def all_reduce_raw(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, a new tensor (``dim`` unused)."""
    g, _ = mesh.group(axis)
    out = _staged(x, mesh).clone()
    if g is not None:
        dist.all_reduce(out, group=g)
    return out.to(x.device)


def all_gather_raw(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order."""
    g, ranks = mesh.group(axis)
    if g is None:
        return x
    send = _staged(x.movedim(dim, 0), mesh)
    if mesh.backend == "gloo":
        parts = [torch.empty_like(send) for _ in ranks]
        dist.all_gather(parts, send, group=g)
        out = torch.cat(parts)
    else:
        out = send.new_empty((len(ranks) * send.shape[0], *send.shape[1:]))
        dist.all_gather_into_tensor(out, send, group=g)
    return out.to(x.device).movedim(0, dim)


def reduce_scatter_raw(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axis``."""
    g, ranks = mesh.group(axis)
    if g is None:
        return x
    n, i = len(ranks), mesh.axis_index(axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter over {axis!r} ({n} ranks) splits a size of "
                         f"{x.shape[dim]}")
    m = x.shape[dim] // n
    if mesh.backend == "gloo":
        return all_reduce_raw(x, mesh, axis).narrow(dim, i * m, m)
    send = x.movedim(dim, 0).contiguous()
    out = send.new_empty((m, *send.shape[1:]))
    dist.reduce_scatter_tensor(out, send, group=g)
    return out.movedim(0, dim)


def _identity(x, mesh, axis, dim):
    return x


_RAW = {"identity": _identity, "all_reduce": all_reduce_raw, "all_gather": all_gather_raw,
        "reduce_scatter": reduce_scatter_raw}


class _TPCollective(torch.autograd.Function):
    """One raw collective forward and another backward."""

    @staticmethod
    def forward(ctx, fwd, bwd, mesh, axis, dim, x):
        ctx.args = (bwd, mesh, axis, dim)
        return _RAW[fwd](x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        bwd, mesh, axis, dim = ctx.args
        return None, None, None, None, None, _RAW[bwd](g, mesh, axis, dim)


def _tp(fwd: str, bwd: str, x, mesh, axis: str, dim: int = 0):
    if mesh.axis_size(axis) == 1:
        return x
    return _TPCollective.apply(fwd, bwd, mesh, axis, dim % max(x.dim(), 1), x)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``axis``."""
    return _tp("identity", "all_reduce", x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``axis``; its gradient as it is."""
    return _tp("all_reduce", "identity", x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` over ``axis``; the
    gradient summed over the axis and this rank's block kept."""
    return _tp("all_gather", "reduce_scatter", x, mesh, axis, dim)


class TensorParallel:
    """The tensor-parallel axis of a model's forward: this rank's index and
    the axis size, and the three operators over the axis."""

    def __init__(self, mesh, axis: str = "model"):
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis: {dict(mesh.shape)}")
        self.mesh, self.axis = mesh, axis
        self.size, self.index = mesh.axis_size(axis), mesh.axis_index(axis)

    def copy_to(self, x):
        return copy_to(x, self.mesh, self.axis)

    def reduce_from(self, x):
        return reduce_from(x, self.mesh, self.axis)

    def gather_from(self, x, dim: int = -1):
        return gather_from(x, self.mesh, self.axis, dim)
