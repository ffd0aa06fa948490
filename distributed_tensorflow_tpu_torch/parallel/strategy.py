"""Execution strategy of the port: one device.

Counterpart of ``distributed_tensorflow_tpu/parallel/strategy.py``'s
``TrainState`` and ``SingleDevice`` (the reference's ``tfsingle.py``
mode). A strategy owns where the state and the batches live and how one
step updates the state; the trainer calls ``init_state`` once, then
``train_step(state, x, y) -> (state, cost)`` per batch. The gradient is
torch autograd's where the JAX package takes ``jax.value_and_grad``;
costs stay on the device until the caller reads them.

The data-parallel strategies (sync, async, sharded) are ROADMAP A6.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.ops import losses as losses_lib


class TrainState(NamedTuple):
    """Training state. ``step`` is the reference's ``global_step``, kept on
    the host as a Python int."""

    params: Any
    opt_state: Any
    step: int


def sgd_step(model, loss_fn, optimizer, params, opt_state, x, y):
    """One update: the cost of ``loss_fn(model.apply(params, x), y)``, its
    gradient by autograd, and ``optimizer.update(grads, opt_state,
    params)`` (any optimizer of ``ops/optim.py``). Returns ``(params,
    opt_state, cost)`` with the cost detached on the device. Shared by the
    eager step and the device loop (``train/scan.py``), so every path
    updates identically."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        cost = loss_fn(model.apply(type(params)(*leaves), x), y)
        grads = torch.autograd.grad(cost, leaves)
    with torch.no_grad():
        new, opt_state = optimizer.update(
            type(params)(*grads), opt_state, type(params)(*(p.detach() for p in leaves))
        )
    return new, opt_state, cost.detach()


class SingleDevice:
    """Everything on one device (default cuda; ``device="cpu"`` for the
    plain versions on the CPU)."""

    num_replicas = 1

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def init_state(self, model, optimizer, seed: int) -> TrainState:
        params = model.init(seed, device=self.device)
        return TrainState(params, optimizer.init(params), 0)

    def make_train_step(self, model, loss_fn, optimizer):
        def step(state: TrainState, x, y):
            params, opt_state, cost = sgd_step(
                model, loss_fn, optimizer, state.params, state.opt_state, x, y
            )
            return TrainState(params, opt_state, state.step + 1), cost

        return step

    def make_eval_fn(self, model):
        @torch.no_grad()
        def evaluate(state: TrainState, x, y):
            return losses_lib.accuracy(model.apply(state.params, x), y)

        return evaluate

    def prepare_batch(self, x, y):
        """A host batch onto the device."""
        return torch.as_tensor(x, device=self.device), torch.as_tensor(y, device=self.device)

    def global_step(self, state: TrainState) -> int:
        return int(state.step)

    def cost_scalar(self, cost) -> float:
        return float(cost)

    def make_indexed_scanned_train_fn(self, model, loss_fn, optimizer):
        from distributed_tensorflow_tpu_torch.train.scan import make_indexed_scanned_train_fn

        return make_indexed_scanned_train_fn(model, loss_fn, optimizer)

    def make_compiled_run_fn(self, model, loss_fn, optimizer, **kw):
        from distributed_tensorflow_tpu_torch.train.compiled_run import make_compiled_run_fn

        return make_compiled_run_fn(model, loss_fn, optimizer, **kw)
