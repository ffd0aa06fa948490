"""Scanned multi-step training: one device loop per epoch.

Counterpart of ``distributed_tensorflow_tpu/train/scan.py``. The JAX
package compiles an epoch into one ``lax.scan`` dispatch; here the scan is
a Python loop of device steps over batches staged on the device, with the
per-step costs kept on the device and fetched once by the caller
(:func:`device_loop`, which the whole run of ``train/compiled_run.py``
also calls). The update sequence is the eager loop's: same batches, same
order, same updates (``parallel.strategy.sgd_step``, any optimizer of
``ops/optim.py`` with its state carried through).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState, sgd_step


def device_loop(model, loss_fn, optimizer, state: TrainState, steps: int, batch):
    """The one MLP device loop: ``steps`` updates (``sgd_step``), step i on
    ``batch(i) -> (x, y)``, the costs kept in a [steps] device tensor for
    the caller to fetch once. The scanned epochs below and the whole run
    (``train/compiled_run.py``) are its callers."""
    params, opt_state = state.params, state.opt_state
    costs = torch.empty(steps, dtype=torch.float32, device=tree_leaves(params)[0].device)
    for i in range(steps):
        params, opt_state, costs[i] = sgd_step(
            model, loss_fn, optimizer, params, opt_state, *batch(i)
        )
    return TrainState(params, opt_state, state.step + steps), costs


def make_scanned_train_fn(model, loss_fn, optimizer):
    """``fn(state, xs, ys) -> (state, costs)`` over staged batches ``xs``
    [steps, batch, features]; ``costs`` [steps] on the device."""

    def run(state: TrainState, xs, ys):
        return device_loop(model, loss_fn, optimizer, state, xs.shape[0],
                           lambda i: (xs[i], ys[i]))

    return run


def make_indexed_scanned_train_fn(model, loss_fn, optimizer):
    """``fn(state, train_x, train_y, idxs) -> (state, costs)`` over the FULL
    device-resident training arrays; ``idxs`` [steps, batch] row indices,
    each step gathering its batch on the device (the only per-epoch upload
    is the index array)."""

    def run(state: TrainState, train_x, train_y, idxs):
        return device_loop(
            model, loss_fn, optimizer, state, idxs.shape[0],
            lambda i: (train_x.index_select(0, idxs[i]), train_y.index_select(0, idxs[i])),
        )

    return run


def stage_epoch(images, labels, batch_size: int, *, rng=None, dtype=np.float32):
    """Shape one epoch of host data into [steps, batch, ...] slices
    (shuffled like ``DataSet.next_batch`` when ``rng`` is given)."""
    n = (images.shape[0] // batch_size) * batch_size
    perm = rng.permutation(images.shape[0])[:n] if rng is not None else np.arange(n)
    xs = images[perm].reshape(-1, batch_size, images.shape[1]).astype(dtype)
    ys = labels[perm].reshape(-1, batch_size, labels.shape[1]).astype(dtype)
    return xs, ys
