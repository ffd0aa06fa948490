"""ZeRO-3 sharded data parallelism.

Counterpart of ``distributed_tensorflow_tpu/parallel/fsdp.py``. The JAX
package states the layout as GSPMD annotations and lets XLA insert the
collectives; here they are written out, from ``all_reduce`` alone
(``parallel/mesh.py``):

- each rank owns a 1/N slice of every parameter that :func:`fsdp_specs`
  shards, and of the optimizer state that tracks it; tensors with no dim
  the ranks divide stay whole on every rank;
- the forward gathers the parameters: an all-reduce of a zero bucket into
  which each rank wrote its slices (exact, the other ranks add zeros);
- the gradients and the cost are summed by ONE all-reduce of a flat bucket
  and divided by N, exactly as :class:`SyncDataParallel` does, and each
  rank keeps its slice (all-reduce, then a slice: the reduce-scatter);
- the optimizer updates the slices; its elementwise arithmetic on a slice
  is the same as on the whole, so the result equals sync bit for bit.
  Global-norm clipping sums the squares over every rank's slices
  (``ops/optim.squares_over``).
"""

from __future__ import annotations

from typing import Any

import torch

from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten
from distributed_tensorflow_tpu_torch.parallel.mesh import World, make_mesh
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy,
    TrainState,
    loss_and_grads,
)


def fsdp_specs(params: Any, world: World | int, *, axis: str = "data", base: Any = None) -> Any:
    """Per parameter, the tuple of ``PartitionSpec`` entries sharding its
    largest dim that the ``axis`` size divides over ``axis`` (the first of
    equal ones); ``()`` for a tensor with no such dim. ``world`` is the
    world or its size. A tensor-parallel ``base`` layout is ROADMAP A7b."""
    if base is not None:
        raise NotImplementedError("fsdp_specs(base=...): tensor-parallel layouts are not "
                                  "ported yet (ROADMAP A7b)")
    n = world if isinstance(world, int) else world.size

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        best = None
        for d, size in enumerate(shape):
            if size % n == 0 and size >= n and (best is None or size > shape[best]):
                best = d
        return () if best is None else (None,) * best + (axis,)

    return tree_map(spec_for, params)


def spec_leaves(specs) -> list:
    """The spec tuples of a tree of NamedTuples whose leaves are spec
    tuples (``tree_leaves`` would open the specs themselves)."""
    if hasattr(specs, "_fields"):
        return [s for sub in specs for s in spec_leaves(sub)]
    return [specs]


def _dim(spec) -> int | None:
    return len(spec) - 1 if spec else None


class ShardedDataParallel(Strategy):
    """Sync DP with ZeRO-3 parameter and optimizer-state sharding (see the
    module docstring): the same batches give the same parameters as
    :class:`SyncDataParallel`; only the memory layout and the collectives
    differ."""

    def __init__(self, world: World | None = None, *, axis: str = "data", param_specs=None,
                 device=None):
        if param_specs is not None:
            raise NotImplementedError(
                "ShardedDataParallel(param_specs=...): tensor-parallel layouts are not "
                "ported yet (ROADMAP A7b)")
        self.world = world if world is not None else make_mesh(device)
        self.axis = axis
        self._specs = None  # per-parameter specs, resolved in init_state
        self._params_type = None

    # -- layout -----------------------------------------------------------

    def _resolve(self, params):
        if self._specs is None:
            self._specs = spec_leaves(fsdp_specs(params, self.world, axis=self.axis))
            self._params_type = type(params)

    def _shard_params(self, tree):
        """A params-shaped tree of whole tensors → this rank's slices."""
        r, n = self.world.rank, self.world.size

        def cut(t, spec):
            d = _dim(spec)
            if d is None:
                return t
            s = t.shape[d] // n
            return t.narrow(d, r * s, s).clone()

        return tree_unflatten(tree, [cut(t, sp) for t, sp in zip(tree_leaves(tree), self._specs)])

    def _gather_params(self, tree):
        """A params-shaped tree of slices → the whole tensors (one
        all-reduce of a zero bucket holding this rank's slices)."""
        leaves = tree_leaves(tree)
        sharded = [i for i, sp in enumerate(self._specs) if sp]
        if self.world.group is None or not sharded:
            return tree
        r, n = self.world.rank, self.world.size
        shapes = []
        for i in sharded:
            shape = list(leaves[i].shape)
            shape[_dim(self._specs[i])] *= n
            shapes.append(shape)
        flat = torch.zeros(sum(torch.Size(s).numel() for s in shapes),
                           dtype=leaves[sharded[0]].dtype, device=leaves[sharded[0]].device)
        views, at = [], 0
        for i, shape in zip(sharded, shapes):
            size = torch.Size(shape).numel()
            view = flat[at : at + size].view(shape)
            d = _dim(self._specs[i])
            s = leaves[i].shape[d]
            view.narrow(d, r * s, s).copy_(leaves[i])
            views.append(view)
            at += size
        self.world.all_reduce_(flat)
        out = list(leaves)
        for i, view in zip(sharded, views):
            out[i] = view
        return tree_unflatten(tree, out)

    def _map_opt(self, opt_state, fn):
        """``fn`` over the params-shaped subtrees of an optimizer state (the
        slots that track a parameter each); the other leaves as they are."""
        if isinstance(opt_state, self._params_type):
            return fn(opt_state)
        if isinstance(opt_state, tuple):
            return type(opt_state)(*(self._map_opt(sub, fn) for sub in opt_state))
        return opt_state

    def _squares(self, grads) -> torch.Tensor:
        """The sum of squares of the whole gradient from this rank's
        slices: the sharded leaves' sums added over the ranks, the whole
        leaves' once."""
        leaves = tree_leaves(grads)
        part = sum(torch.sum(g * g) for g, sp in zip(leaves, self._specs) if sp)
        whole = sum(torch.sum(g * g) for g, sp in zip(leaves, self._specs) if not sp)
        part = self.world.all_reduce_(torch.as_tensor(part, device=self.device).reshape(1))[0]
        return part + whole

    def placement_specs(self, params):
        return tree_unflatten(params, list(self._specs))

    # -- the strategy -----------------------------------------------------

    def init_state(self, model, optimizer, seed: int) -> TrainState:
        params = model.init(seed, device=self.device)
        self._resolve(params)
        return TrainState(self._shard_params(params),
                          self._map_opt(optimizer.init(params), self._shard_params), 0)

    def effective_params(self, state: TrainState):
        return self._gather_params(state.params)

    def to_canonical(self, state: TrainState) -> TrainState:
        return TrainState(self._gather_params(state.params),
                          self._map_opt(state.opt_state, self._gather_params),
                          self.global_step(state))

    def from_canonical(self, canonical: TrainState) -> TrainState:
        self._resolve(canonical.params)
        to_dev = lambda t: tree_map(lambda a: a.to(self.device), t)  # noqa: E731
        return TrainState(self._shard_params(to_dev(canonical.params)),
                          self._map_opt(canonical.opt_state, lambda t: self._shard_params(to_dev(t))),
                          int(canonical.step))

    def _update(self, model, loss_fn, optimizer):
        world = self.world

        def update(shards, opt_state, x, y):
            full = self._gather_params(shards)
            cost, grads = loss_and_grads(model, loss_fn, full, x, y)
            *leaves, cost = world.mean_(tree_leaves(grads) + [cost.reshape(1)])
            gshards = self._shard_params(tree_unflatten(grads, leaves))
            with torch.no_grad(), optim_lib.squares_over(self._squares):
                new, opt_state = optimizer.update(gshards, opt_state, shards)
            return new, opt_state, cost.reshape(())

        return update
