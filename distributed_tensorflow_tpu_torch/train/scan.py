"""Scanned multi-step training: one device loop per epoch.

Counterpart of ``distributed_tensorflow_tpu/train/scan.py``. The JAX
package compiles an epoch into one ``lax.scan`` dispatch; here the scan is
a Python loop of device steps over batches staged on the device, with the
per-step costs kept on the device and fetched once by the caller. The
update sequence is the eager loop's: same batches, same order, same
updates (``parallel.strategy.sgd_step``).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState, sgd_step


def make_scanned_train_fn(model, loss_fn, optimizer):
    """``fn(state, xs, ys) -> (state, costs)`` over staged batches ``xs``
    [steps, batch, features]; ``costs`` [steps] on the device."""

    def run(state: TrainState, xs, ys):
        params = state.params
        costs = torch.empty(xs.shape[0], dtype=torch.float32, device=xs.device)
        for i in range(xs.shape[0]):
            params, costs[i] = sgd_step(model, loss_fn, optimizer, params, xs[i], ys[i])
        return TrainState(params, state.opt_state, state.step + xs.shape[0]), costs

    return run


def make_indexed_scanned_train_fn(model, loss_fn, optimizer):
    """``fn(state, train_x, train_y, idxs) -> (state, costs)`` over the FULL
    device-resident training arrays; ``idxs`` [steps, batch] row indices,
    each step gathering its batch on the device (the only per-epoch upload
    is the index array)."""

    def run(state: TrainState, train_x, train_y, idxs):
        params = state.params
        costs = torch.empty(idxs.shape[0], dtype=torch.float32, device=train_x.device)
        for i in range(idxs.shape[0]):
            x = train_x.index_select(0, idxs[i])
            y = train_y.index_select(0, idxs[i])
            params, costs[i] = sgd_step(model, loss_fn, optimizer, params, x, y)
        return TrainState(params, state.opt_state, state.step + idxs.shape[0]), costs

    return run


def stage_epoch(images, labels, batch_size: int, *, rng=None, dtype=np.float32):
    """Shape one epoch of host data into [steps, batch, ...] slices
    (shuffled like ``DataSet.next_batch`` when ``rng`` is given)."""
    n = (images.shape[0] // batch_size) * batch_size
    perm = rng.permutation(images.shape[0])[:n] if rng is not None else np.arange(n)
    xs = images[perm].reshape(-1, batch_size, images.shape[1]).astype(dtype)
    ys = labels[perm].reshape(-1, batch_size, labels.shape[1]).astype(dtype)
    return xs, ys
