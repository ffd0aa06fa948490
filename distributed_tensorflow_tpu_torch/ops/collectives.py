"""Ring collectives over a mesh axis.

Counterpart of ``distributed_tensorflow_tpu/ops/collectives.py``
``ring_all_reduce`` / ``ring_all_mean`` / ``ring_all_gather`` (:69-107):
explicit ring algorithms of n − 1 neighbour hops, each hop one
:meth:`parallel.mesh.Mesh.ring_permute` (the JAX ``lax.ppermute`` with the
ring's permutation ``[(j, (j + 1) % n)]``, ``_ring_perm`` :28), the same
primitive that moves ring attention's KV blocks. They serve the async
strategy's periodic exchange (``AsyncDataParallel.make_exchange_fn(
collective="ring")``) and are differentiable, as the permute is.

Each function takes this rank's tensor, the :class:`~parallel.mesh.Mesh`
and the axis name, and is a collective: every rank of the axis calls it.
"""

from __future__ import annotations

import torch


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
