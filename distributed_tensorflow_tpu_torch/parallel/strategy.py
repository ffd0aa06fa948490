"""Execution strategies of the port: the reference's run modes.

Counterpart of ``distributed_tensorflow_tpu/parallel/strategy.py``:

- ``tfsingle.py`` (one device)                 → :class:`SingleDevice`
- ``tfdist_between_sync.py`` (sync DP over PS) → :class:`SyncDataParallel`
- ``tfdist_between.py`` (async/HOGWILD DP)     → :class:`AsyncDataParallel`
- ZeRO-3 sync DP                               → ``parallel/fsdp.py``

A strategy owns where the state and the batches live and how one step
updates the state; the trainer calls ``init_state`` once, then
``train_step(state, x, y) -> (state, cost)`` per batch. The gradient is
torch autograd's; costs stay on the device until the caller reads them.

Data parallelism runs over ``torch.distributed`` on a
:class:`~parallel.mesh.Mesh` (``parallel/mesh.py``): one process is one
rank is one device, and the batch and the gradient all-reduce ride the
mesh's ``data`` axis. Every rank draws the same global batch and keeps its
rows ``[i·b, (i+1)·b)`` for its index i along ``data`` (JAX ``P("data")``),
so N ranks compute what the JAX package computes on an N-device mesh.

- Tensor parallelism (``SyncDataParallel(mesh, param_specs=
  model.partition_specs())``, JAX :272-320): each rank keeps its block of
  every leaf the specs split over the mesh's ``model`` axis
  (``parallel/specs.shard_tree``), the model's forward runs on the blocks
  with Megatron's collectives over that axis (``model.apply(params, x,
  tp=...)``, ``ops/collectives.TensorParallel``), the gradients are
  averaged over ``data`` only and the update runs on the blocks
  (``parallel/specs.pinned_update``). The JAX package inserts the same
  collectives by GSPMD.

- Sync: the loss on the local rows, the gradients and the cost summed over
  the ranks by ONE all-reduce of a flat bucket and divided by N (the mean
  over the global batch, as the JAX step's); ``explicit_collectives=True``
  reduces leaf by leaf, with the same result.
- Async: each rank keeps its own copy and steps on its own rows with the
  update scaled by ``update_scale`` (``None`` = N, the reference's
  N×-update-count effect); every ``avg_every`` steps the copies jump to
  their mean (:meth:`AsyncDataParallel.make_exchange_fn`). The step is a
  per-rank count: ``TrainState.step`` holds every rank's (a tuple, as the
  JAX ``[n]`` vector; the ranks step in lockstep, so each rank knows them
  all) and ``global_step`` is their sum.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from distributed_tensorflow_tpu_torch.data.sharded import global_batch
from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten
from distributed_tensorflow_tpu_torch.ops.collectives import TensorParallel
from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh, batch_sharded, make_mesh
from distributed_tensorflow_tpu_torch.parallel.specs import (
    check_layout,
    gather_tree,
    match_slot_specs,
    pinned_update,
    shard_tree,
    spec_leaves,
)


class TrainState(NamedTuple):
    """Training state. ``step`` is the reference's ``global_step``: a host
    int, or under async a tuple of every rank's count."""

    params: Any
    opt_state: Any
    step: Any


def apply(model, params, x, tp=None):
    """``model.apply``, on the blocks of a tensor-parallel layout over
    ``tp`` (an ``ops/collectives.TensorParallel``) when given."""
    return model.apply(params, x) if tp is None else model.apply(params, x, tp=tp)


def loss_and_grads(model, loss_fn, params, x, y, tp=None):
    """``(cost, grads)`` of ``loss_fn(model.apply(params, x), y)`` by
    autograd, the cost detached on the device (:func:`apply` over ``tp``)."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        cost = loss_fn(apply(model, type(params)(*leaves), x, tp), y)
        grads = torch.autograd.grad(cost, leaves)
    return cost.detach(), type(params)(*grads)


def sgd_step(model, loss_fn, optimizer, params, opt_state, x, y):
    """One update: the cost of ``loss_fn(model.apply(params, x), y)``, its
    gradient by autograd, and ``optimizer.update(grads, opt_state,
    params)`` (any optimizer of ``ops/optim.py``). Returns ``(params,
    opt_state, cost)`` with the cost detached on the device. Shared by the
    eager step and the device loop (``train/scan.py``), so every path
    updates identically."""
    cost, grads = loss_and_grads(model, loss_fn, params, x, y)
    with torch.no_grad():
        new, opt_state = optimizer.update(grads, opt_state, type(params)(*(p.detach() for p in params)))
    return new, opt_state, cost


def _local_sgd_update(model, loss_fn, optimizer, scale: float, params, opt_state, x, y):
    """One local optimizer apply with its update scaled by ``scale`` (the
    async step, eager and scanned alike). The port's optimizers return new
    parameters, so the scaled update is ``p + scale·(new − p)``; at scale 1
    it is :func:`sgd_step` itself, bit for bit."""
    new, opt_state, cost = sgd_step(model, loss_fn, optimizer, params, opt_state, x, y)
    if scale != 1.0:
        with torch.no_grad():
            new = tree_map(lambda p, q: p + (q - p) * scale, params, new)
    return new, opt_state, cost


def merge_replica_leaf(a, mesh: Mesh, axis: str = "data"):
    """Fold one leaf held by every rank of ``axis`` into the canonical
    single copy: float leaves merge at the mean over the ranks (async's
    effective_params); integer leaves (Adam's count, the accumulator's
    mini-step) take rank 0's value, which must equal every rank's: a
    mismatch raises rather than merge. Collective: every rank calls it."""
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return mesh.mean_([a], axis)[0].to(a.dtype)
    t = torch.as_tensor(a, device=mesh.device).to(torch.int64)
    if mesh.axis_size(axis) > 1:
        hi = mesh.all_reduce_(t.clone(), axis, "max")
        lo = mesh.all_reduce_(t.clone(), axis, "min")
        if not torch.equal(hi, lo):
            raise ValueError(
                "integer optimizer-state leaf differs across replicas; "
                "refusing to merge (the copies should be identical)"
            )
    return a.clone() if isinstance(a, torch.Tensor) else a


def merge_stacked_leaf(a):
    """Fold copies stacked ``[n, ...]`` (a checkpoint's async or DiLoCo
    leaf) into the canonical single copy, as :func:`merge_replica_leaf`
    folds them across ranks: float leaves at their mean (the sum over the
    copies divided by n), integer leaves from copy 0, which must equal
    every copy's; a host value as it is."""
    if not isinstance(a, torch.Tensor):
        return a
    if a.is_floating_point():
        return (a.sum(0) / a.shape[0]).to(a.dtype)
    if not torch.equal(a.amax(0), a.amin(0)):
        raise ValueError(
            "integer optimizer-state leaf differs across replicas; "
            "refusing to merge (the copies should be identical)"
        )
    return a[0].clone()


def _merge_tree(tree, mesh: Mesh):
    return tree_unflatten(tree, [merge_replica_leaf(a, mesh) for a in tree_leaves(tree)])


def device_loop(update, state: TrainState, steps: int, batch, *, exchange=None,
                avg_every: int = 0):
    """The one MLP device loop: ``steps`` calls of ``update(params,
    opt_state, x, y) -> (params, opt_state, cost)``, step i on ``batch(i)
    -> (x, y)``, the costs kept in a [steps] device tensor. With
    ``exchange``, ``params = exchange(params)`` runs after step i when
    ``(i + 1) % avg_every == 0``: after every full round, an epoch-final
    one included when the count divides; the remainder runs after the last
    exchange, and an epoch shorter than ``avg_every`` exchanges nothing
    (the JAX ``_scan_with_exchange`` cadence). Returns ``(params,
    opt_state, costs)``."""
    params, opt_state = state.params, state.opt_state
    costs = torch.empty(steps, dtype=torch.float32, device=tree_leaves(params)[0].device)
    for i in range(steps):
        params, opt_state, costs[i] = update(params, opt_state, *batch(i))
        if exchange is not None and avg_every and (i + 1) % avg_every == 0:
            params = exchange(params)
    return params, opt_state, costs


def _advance(step, k: int):
    """A step count advanced by ``k`` steps (every rank's, under async)."""
    return tuple(s + k for s in step) if isinstance(step, tuple) else step + k


class Strategy:
    """Interface. Subclasses define placement and aggregation."""

    mesh: Mesh
    _tp = None  # the TensorParallel axis of a layout that splits leaves over one

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def num_replicas(self) -> int:
        return self.mesh.axis_size("data")

    def global_step(self, state: TrainState) -> int:
        step = state.step
        return int(sum(step)) if isinstance(step, tuple) else int(step)

    def effective_params(self, state: TrainState):
        """The single parameter set this state denotes ("the parameters on
        the PS"); async overrides with the mean of the copies."""
        return state.params

    def cost_scalar(self, cost) -> float:
        return float(cost)

    # Cross-topology interchange: every state is a re-layout of ONE
    # canonical form, the single-device (params, opt_state, int step).
    def to_canonical(self, state: TrainState) -> TrainState:
        return TrainState(state.params, state.opt_state, self.global_step(state))

    def from_canonical(self, canonical: TrainState) -> TrainState:
        return canonical

    def layout_meta(self) -> dict:
        return {"mode": "sync"}

    def placement_specs(self, params):
        """Per leaf, the mesh axes its dims are split over (JAX
        ``PartitionSpec`` entries as a tuple): replicated by default."""
        return tree_map(lambda _: (), params)

    def prepare_batch(self, x, y):
        """This rank's rows of a host global batch, on its device."""
        return global_batch(self.mesh, x, y)

    def _eval_params(self, state: TrainState):
        """The parameters the eval's forward takes (over ``_tp``)."""
        return self.effective_params(state)

    def make_eval_fn(self, model):
        @torch.no_grad()
        def evaluate(state: TrainState, x, y):
            return losses_lib.accuracy(apply(model, self._eval_params(state), x, self._tp), y)

        return evaluate

    def _update(self, model, loss_fn, optimizer):
        """``update(params, opt_state, x, y) -> (params, opt_state, cost)``
        on this rank's rows."""
        raise NotImplementedError

    def make_train_step(self, model, loss_fn, optimizer):
        update = self._update(model, loss_fn, optimizer)

        def step(state: TrainState, x, y):
            params, opt_state, cost = update(state.params, state.opt_state, x, y)
            return TrainState(params, opt_state, _advance(state.step, 1)), cost

        return step

    def _epoch_costs(self, costs):
        """An epoch's per-step costs as the logs read them."""
        return costs

    def _loop_kw(self) -> dict:
        return {}

    def make_scanned_train_fn(self, model, loss_fn, optimizer):
        """``fn(state, xs, ys) -> (state, costs)`` over staged GLOBAL
        batches ``xs`` [steps, global batch, ...]: each rank steps on its
        columns."""
        update = self._update(model, loss_fn, optimizer)

        def run(state: TrainState, xs, ys):
            cols = batch_sharded(self.mesh, xs.shape[1])
            params, opt_state, costs = device_loop(
                update, state, xs.shape[0], lambda i: (xs[i, cols], ys[i, cols]),
                **self._loop_kw())
            return (TrainState(params, opt_state, _advance(state.step, xs.shape[0])),
                    self._epoch_costs(costs))

        return run

    def make_indexed_scanned_train_fn(self, model, loss_fn, optimizer):
        """``fn(state, train_x, train_y, idxs) -> (state, costs)`` over the
        full device-resident arrays; ``idxs`` [steps, global batch] row
        indices, this rank gathering columns ``[r·b, (r+1)·b)`` of each
        step's row, the eager loop's split."""
        update = self._update(model, loss_fn, optimizer)

        def run(state: TrainState, train_x, train_y, idxs):
            mine = idxs[:, batch_sharded(self.mesh, idxs.shape[1])]
            params, opt_state, costs = device_loop(
                update, state, idxs.shape[0],
                lambda i: (train_x.index_select(0, mine[i]), train_y.index_select(0, mine[i])),
                **self._loop_kw())
            return (TrainState(params, opt_state, _advance(state.step, idxs.shape[0])),
                    self._epoch_costs(costs))

        return run

    def make_compiled_run_fn(self, model, loss_fn, optimizer, **kw):
        from distributed_tensorflow_tpu_torch.train.compiled_run import make_compiled_run_fn

        return make_compiled_run_fn(
            model, loss_fn, optimizer,
            epoch_fn=self.make_indexed_scanned_train_fn(model, loss_fn, optimizer),
            eval_fn=self.make_eval_fn(model), **kw,
        )


class SingleDevice(Strategy):
    """Everything on one device (default cuda; ``device="cpu"`` for the
    plain versions on the CPU)."""

    def __init__(self, device=None):
        self.mesh = Mesh({"data": 1, "model": 1}, device=resolve_device(device))

    def init_state(self, model, optimizer, seed: int) -> TrainState:
        params = model.init(seed, device=self.device)
        return TrainState(params, optimizer.init(params), 0)

    def prepare_batch(self, x, y):
        """A host batch onto the device."""
        return torch.as_tensor(x, device=self.device), torch.as_tensor(y, device=self.device)

    def _update(self, model, loss_fn, optimizer):
        return lambda params, opt_state, x, y: sgd_step(
            model, loss_fn, optimizer, params, opt_state, x, y)


def tensor_parallel(mesh: Mesh, param_specs):
    """The ``TensorParallel`` axis of a layout (the one axis other than
    ``data`` its specs split over), or None for no layout or one that
    splits nothing."""
    if param_specs is None:
        return None
    axes = sorted({e for sp in spec_leaves(param_specs) for e in sp if e is not None})
    if len(axes) > 1 or "data" in axes:
        raise ValueError(f"param_specs must split over one tensor-parallel axis other than "
                         f"'data', got {axes}")
    return TensorParallel(mesh, axes[0]) if axes else None


class SyncDataParallel(Strategy):
    """The ``tfdist_between_sync.py`` mode: lockstep DP with gradient
    averaging, ``SyncReplicasOptimizer`` rebuilt as an all-reduce over the
    mesh's ``data`` axis.

    ``explicit_collectives=False`` (default): one all-reduce of a flat
    bucket of every gradient and the cost a step.
    ``explicit_collectives=True``: one all-reduce a leaf, the collective of
    each gradient visible (the JAX ``shard_map`` + ``pmean`` path); the
    same sums, so the same result. Like the JAX one, it serves the eager
    step only.

    ``param_specs`` (e.g. ``MLP.partition_specs()``): tensor parallelism
    over the one axis the specs name (the mesh's ``model`` axis) on top of
    DP over ``data``: each rank keeps its blocks of the parameters and of
    the optimizer slots that track them (see the module docstring). A
    layout whose axis size does not divide a split dim is refused."""

    def __init__(self, mesh: Mesh | None = None, *, explicit_collectives: bool = False,
                 param_specs=None, device=None):
        if explicit_collectives and param_specs is not None:
            raise ValueError("explicit_collectives path supports pure DP only")
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.explicit = explicit_collectives
        self.param_specs = param_specs
        self._tp = tensor_parallel(self.mesh, param_specs)

    def init_state(self, model, optimizer, seed: int) -> TrainState:
        # Every rank builds the same parameters from the same seed (the
        # reference's tf.set_random_seed(1) in each process).
        params = model.init(seed, device=self.device)
        return self.from_canonical(TrainState(params, optimizer.init(params), 0))

    def from_canonical(self, canonical: TrainState) -> TrainState:
        """The canonical state as this rank's (its blocks under a layout,
        which is refused where its axis does not divide a split dim)."""
        if self.param_specs is None:
            return canonical
        check_layout(canonical.params, self.param_specs, self.mesh)
        on = lambda t: tree_map(  # noqa: E731
            lambda a: a.to(self.device) if isinstance(a, torch.Tensor) else a, t)
        params, opt_state = on(canonical.params), on(canonical.opt_state)
        slots = match_slot_specs(opt_state, params, self.param_specs)
        return TrainState(shard_tree(params, self.param_specs, self.mesh),
                          shard_tree(opt_state, slots, self.mesh), int(canonical.step))

    def to_canonical(self, state: TrainState) -> TrainState:
        """The whole parameters and optimizer state, gathered from every
        rank's blocks (a collective over the tensor-parallel axis)."""
        if self.param_specs is None:
            return super().to_canonical(state)
        slots = match_slot_specs(state.opt_state, state.params, self.param_specs)
        return TrainState(gather_tree(state.params, self.param_specs, self.mesh),
                          gather_tree(state.opt_state, slots, self.mesh),
                          self.global_step(state))

    def effective_params(self, state: TrainState):
        if self.param_specs is None:
            return state.params
        return gather_tree(state.params, self.param_specs, self.mesh)

    def _eval_params(self, state: TrainState):
        return state.params

    def placement_specs(self, params):
        return super().placement_specs(params) if self.param_specs is None else self.param_specs

    def _update(self, model, loss_fn, optimizer):
        mesh, n, tp, specs = self.mesh, self.num_replicas, self._tp, self.param_specs

        def update(params, opt_state, x, y):
            cost, grads = loss_and_grads(model, loss_fn, params, x, y, tp)
            leaves = tree_leaves(grads)
            if self.explicit:
                leaves = [mesh.all_reduce_(g, "data") / n for g in leaves]
                cost = mesh.all_reduce_(cost.clone(), "data") / n
            else:
                *leaves, cost = mesh.mean_(leaves + [cost.reshape(1)], "data")
                cost = cost.reshape(())
            grads = tree_unflatten(grads, leaves)
            params = type(params)(*(p.detach() for p in params))
            if specs is None:
                with torch.no_grad():
                    new, opt_state = optimizer.update(grads, opt_state, params)
            else:
                new, opt_state = pinned_update(optimizer, params, opt_state, grads, mesh, specs)
            return new, opt_state, cost

        return update

    def _explicit_refused(self, what: str):
        if self.explicit:
            raise NotImplementedError(f"{what} uses the bucket path; explicit_collectives=False")

    def make_scanned_train_fn(self, model, loss_fn, optimizer):
        self._explicit_refused("scan_epoch")
        return super().make_scanned_train_fn(model, loss_fn, optimizer)

    def make_indexed_scanned_train_fn(self, model, loss_fn, optimizer):
        self._explicit_refused("scan_epoch")
        return super().make_indexed_scanned_train_fn(model, loss_fn, optimizer)

    def make_compiled_run_fn(self, model, loss_fn, optimizer, **kw):
        self._explicit_refused("compiled run")
        return super().make_compiled_run_fn(model, loss_fn, optimizer, **kw)


class AsyncDataParallel(Strategy):
    """The ``tfdist_between.py`` mode: HOGWILD-style async DP as local SGD
    with a copy a rank (see the module docstring)."""

    def __init__(self, mesh: Mesh | None = None, *, avg_every: int = 0,
                 update_scale: float | None = None, device=None):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.n = self.num_replicas
        self.avg_every = avg_every
        # None → scale the update by the replica count (async N×-update-
        # count parity).
        self.update_scale = float(self.n if update_scale is None else update_scale)

    def init_state(self, model, optimizer, seed: int) -> TrainState:
        params = model.init(seed, device=self.device)
        return TrainState(params, optimizer.init(params), (0,) * self.n)

    def layout_meta(self) -> dict:
        return {"mode": "async", "replicas": int(self.n)}

    def placement_specs(self, params):
        return tree_map(lambda _: ("data",), params)

    def to_canonical(self, state: TrainState) -> TrainState:
        """The copies merged at their mean (float leaves; integer leaves
        must agree, ``merge_replica_leaf``) and the summed step."""
        return TrainState(_merge_tree(state.params, self.mesh),
                          _merge_tree(state.opt_state, self.mesh), self.global_step(state))

    def from_canonical(self, canonical: TrainState) -> TrainState:
        """The canonical state as this rank's copy, and the scalar step
        spread over the ranks so that their sum is kept."""
        total = int(canonical.step)
        base, rem = divmod(total, self.n)
        dev = self.device
        copy = lambda t: tree_map(  # noqa: E731
            lambda a: a.detach().to(dev).clone() if isinstance(a, torch.Tensor) else a, t)
        return TrainState(copy(canonical.params), copy(canonical.opt_state),
                          tuple(base + (r < rem) for r in range(self.n)))

    def _update(self, model, loss_fn, optimizer):
        scale = self.update_scale
        return lambda params, opt_state, x, y: _local_sgd_update(
            model, loss_fn, optimizer, scale, params, opt_state, x, y)

    def cost_scalar(self, cost) -> float:
        """The mean over the ranks of a step's cost tensor (collective); a
        host number, already a mean, as it is."""
        if isinstance(cost, torch.Tensor):
            return float(self.mesh.mean_([cost.reshape(1)], "data")[0])
        return float(cost)

    def _mean_params(self, params):
        return tree_unflatten(params, self.mesh.mean_(tree_leaves(params), "data"))

    def make_exchange_fn(self, collective: str = "auto"):
        """Periodic parameter exchange: every copy jumps to the mean;
        optimizer state and steps stay local. ``"auto"`` takes one
        all-reduce of a flat bucket; ``"ring"`` the explicit ring of
        ``ops/collectives.ring_all_mean`` (n − 1 neighbour hops a leaf),
        as the JAX ``make_exchange_fn(collective="ring")``."""
        if collective not in ("auto", "ring"):
            raise ValueError(f"unknown collective {collective!r}; use 'auto' or 'ring'")
        if collective == "ring":
            from distributed_tensorflow_tpu_torch.ops.collectives import ring_all_mean

            @torch.no_grad()
            def ring_mean(params):
                return tree_map(lambda a: ring_all_mean(a, self.mesh, "data"), params)

            return lambda state: TrainState(ring_mean(state.params), state.opt_state, state.step)

        def exchange(state: TrainState) -> TrainState:
            return TrainState(self._mean_params(state.params), state.opt_state, state.step)

        return exchange

    def _loop_kw(self) -> dict:
        return dict(exchange=self._mean_params, avg_every=self.avg_every)

    def _epoch_costs(self, costs):
        # Mean over the ranks a step: what the eager path's cost_scalar
        # logs; one all-reduce an epoch.
        return self.mesh.mean_([costs], "data")[0]

    def make_divergence_fn(self):
        """The largest elementwise distance of any copy from the mean of
        the copies: 0 right after an exchange, growing with local drift.
        A 0-d tensor, the same on every rank (collective)."""

        @torch.no_grad()
        def divergence(state: TrainState) -> torch.Tensor:
            mean = self._mean_params(state.params)
            local = torch.stack([torch.max(torch.abs(a - m))
                                 for a, m in zip(tree_leaves(state.params), tree_leaves(mean))])
            return self.mesh.all_reduce_(torch.max(local).reshape(1), "data", "max")[0]

        return divergence

    def effective_params(self, state: TrainState):
        return self._mean_params(state.params)
