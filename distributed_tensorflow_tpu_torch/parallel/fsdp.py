"""ZeRO-3 sharded data parallelism.

Counterpart of ``distributed_tensorflow_tpu/parallel/fsdp.py``. The JAX
package states the layout as GSPMD annotations and lets XLA insert the
collectives; here they are written out, from ``all_reduce`` alone
(``parallel/mesh.py``):

- each rank owns a 1/N slice of every parameter that :func:`fsdp_specs`
  shards over the mesh's ``data`` axis, and of the optimizer state that
  tracks it; tensors with no dim the ranks divide stay whole on every rank;
- the forward gathers the parameters: an all-reduce over ``data`` of a
  zero bucket into which each rank wrote its slices (exact, the other
  ranks add zeros);
- the gradients and the cost are summed by ONE all-reduce of a flat bucket
  and divided by N, exactly as :class:`SyncDataParallel` does, and each
  rank keeps its slice (all-reduce, then a slice: the reduce-scatter);
- the optimizer updates the slices; its elementwise arithmetic on a slice
  is the same as on the whole, so the result equals sync bit for bit.
  Global-norm clipping sums the squares over every rank's slices
  (``parallel/specs.pinned_update``).

It composes with tensor parallelism (JAX :43-76, :86-90): given a ``base``
layout (``param_specs``, e.g. ``MLP.partition_specs()``), each leaf keeps
the dims the base splits over ``model`` and ZeRO takes the largest
remaining dim over ``data``; the forward gathers over ``data`` only and
runs on the tensor-parallel blocks (``model.apply(..., tp=...)``).
"""

from __future__ import annotations

from typing import Any

import torch

from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_unflatten
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from distributed_tensorflow_tpu_torch.parallel.specs import (
    aligned_specs,
    check_layout,
    gather_tree,
    match_slot_specs,
    pinned_update,
    shard_tree,
    spec_leaves,
)
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy,
    TrainState,
    loss_and_grads,
    tensor_parallel,
)


def fsdp_specs(params: Any, mesh: Mesh | int, *, axis: str = "data", base: Any = None) -> Any:
    """Per parameter, the tuple of ``PartitionSpec`` entries sharding its
    largest dim that the ``axis`` size divides over ``axis`` (the first of
    equal ones); ``mesh`` is the mesh or that size. Dims ``base`` (a spec
    tree, e.g. a tensor-parallel layout) already splits are kept and not
    taken; a tensor with no free dim the size divides stays as ``base``
    says (replicated over ``axis``)."""
    n = mesh if isinstance(mesh, int) else mesh.axis_size(axis)
    leaves = tree_leaves(params)
    bases = [()] * len(leaves) if base is None else aligned_specs(params, base)

    def spec_for(leaf, base_spec):
        entries = list(base_spec) + [None] * (leaf.dim() - len(base_spec))
        best = None
        for d, size in enumerate(leaf.shape):
            if entries[d] is None and size % n == 0 and size >= n and (
                    best is None or size > leaf.shape[best]):
                best = d
        if best is not None:
            entries[best] = axis
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    return tree_unflatten(params, [spec_for(t, b) for t, b in zip(leaves, bases)])


def gather_sharded(tree, specs: list, mesh: Mesh, axis: str = "data"):
    """A tree of this rank's blocks, ``specs`` a spec a leaf (``tree_leaves``
    order) → the blocks whole over ``axis``: one all-reduce over ``axis`` of
    a zero bucket into which each rank wrote its slices (exact: the other
    ranks add zeros). The splits over other axes stay."""
    leaves = tree_leaves(tree)
    sharded = [i for i, sp in enumerate(specs) if axis in sp]
    n = mesh.axis_size(axis)
    if n == 1 or not sharded:
        return tree
    r = mesh.axis_index(axis)
    shapes = []
    for i in sharded:
        shape = list(leaves[i].shape)
        shape[specs[i].index(axis)] *= n
        shapes.append(shape)
    flat = torch.zeros(sum(torch.Size(s).numel() for s in shapes),
                       dtype=leaves[sharded[0]].dtype, device=leaves[sharded[0]].device)
    views, at = [], 0
    for i, shape in zip(sharded, shapes):
        size = torch.Size(shape).numel()
        view = flat[at : at + size].view(shape)
        d = specs[i].index(axis)
        s = leaves[i].shape[d]
        view.narrow(d, r * s, s).copy_(leaves[i])
        views.append(view)
        at += size
    mesh.all_reduce_(flat, axis)
    out = list(leaves)
    for i, view in zip(sharded, views):
        out[i] = view
    return tree_unflatten(tree, out)


class ShardedDataParallel(Strategy):
    """Sync DP with ZeRO-3 parameter and optimizer-state sharding (see the
    module docstring): the same batches give the same parameters as
    :class:`SyncDataParallel`; only the memory layout and the collectives
    differ. ``param_specs``: the tensor-parallel base layout ZeRO is
    layered onto."""

    def __init__(self, mesh: Mesh | None = None, *, axis: str = "data", param_specs=None,
                 device=None):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.axis = axis
        self._base = param_specs
        self._tp = tensor_parallel(self.mesh, param_specs)
        self._spec_tree = None  # per-parameter specs, resolved in init_state
        self._specs = None

    @property
    def num_replicas(self) -> int:
        return self.mesh.axis_size(self.axis)

    # -- layout -----------------------------------------------------------

    def _resolve(self, params):
        if self._spec_tree is None:
            if self._base is not None:
                check_layout(params, self._base, self.mesh)
            self._spec_tree = fsdp_specs(params, self.mesh, axis=self.axis, base=self._base)
            self._specs = spec_leaves(self._spec_tree)

    def _gather_params(self, tree):
        return gather_sharded(tree, self._specs, self.mesh, self.axis)

    def placement_specs(self, params):
        return tree_unflatten(params, list(self._specs))

    # -- the strategy -----------------------------------------------------

    def init_state(self, model, optimizer, seed: int) -> TrainState:
        params = model.init(seed, device=self.device)
        return self.from_canonical(TrainState(params, optimizer.init(params), 0))

    def effective_params(self, state: TrainState):
        return gather_tree(state.params, self._spec_tree, self.mesh)

    def _eval_params(self, state: TrainState):
        return self._gather_params(state.params)

    def to_canonical(self, state: TrainState) -> TrainState:
        slots = match_slot_specs(state.opt_state, state.params, self._spec_tree)
        return TrainState(gather_tree(state.params, self._spec_tree, self.mesh),
                          gather_tree(state.opt_state, slots, self.mesh),
                          self.global_step(state))

    def from_canonical(self, canonical: TrainState) -> TrainState:
        self._resolve(canonical.params)
        slots = match_slot_specs(canonical.opt_state, canonical.params, self._spec_tree)
        on = lambda t: tree_unflatten(t, [  # noqa: E731
            a.to(self.device) if isinstance(a, torch.Tensor) else a for a in tree_leaves(t)])
        return TrainState(shard_tree(on(canonical.params), self._spec_tree, self.mesh),
                          shard_tree(on(canonical.opt_state), slots, self.mesh),
                          int(canonical.step))

    def _update(self, model, loss_fn, optimizer):
        mesh, axis = self.mesh, self.axis

        def update(shards, opt_state, x, y):
            full = self._gather_params(shards)
            cost, grads = loss_and_grads(model, loss_fn, full, x, y, self._tp)
            *leaves, cost = mesh.mean_(tree_leaves(grads) + [cost.reshape(1)], axis)
            gshards = shard_tree(tree_unflatten(grads, leaves), self._spec_tree, mesh, (axis,))
            new, opt_state = pinned_update(optimizer, shards, opt_state, gshards, mesh,
                                           self._spec_tree)
            return new, opt_state, cost.reshape(())

        return update
