"""Scanned multi-step training: one device loop per epoch.

Counterpart of ``distributed_tensorflow_tpu/train/scan.py``. The JAX
package compiles an epoch into one ``lax.scan`` dispatch; here the scan is
a Python loop of device steps over batches staged on the device, with the
per-step costs kept on the device and fetched once by the caller
(``parallel.strategy.device_loop``, which the whole run of
``train/compiled_run.py`` also runs). The update sequence is the eager
loop's: same batches, same order, same updates
(``parallel.strategy.sgd_step``, any optimizer of ``ops/optim.py`` with its
state carried through). These are the one-device functions; each strategy
builds its own over its update and its rows of the batch
(``Strategy.make_indexed_scanned_train_fn``).
"""

from __future__ import annotations

import numpy as np

from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice

# A world of one rank: its scanned functions keep each tensor on the
# device the caller staged it on.
_ONE = SingleDevice("cpu")


def make_scanned_train_fn(model, loss_fn, optimizer):
    """``fn(state, xs, ys) -> (state, costs)`` over staged batches ``xs``
    [steps, batch, features]; ``costs`` [steps] on the device."""
    return _ONE.make_scanned_train_fn(model, loss_fn, optimizer)


def make_indexed_scanned_train_fn(model, loss_fn, optimizer):
    """``fn(state, train_x, train_y, idxs) -> (state, costs)`` over the FULL
    device-resident training arrays; ``idxs`` [steps, batch] row indices,
    each step gathering its batch on the device (the only per-epoch upload
    is the index array)."""
    return _ONE.make_indexed_scanned_train_fn(model, loss_fn, optimizer)


def stage_epoch(images, labels, batch_size: int, *, rng=None, dtype=np.float32):
    """Shape one epoch of host data into [steps, batch, ...] slices
    (shuffled like ``DataSet.next_batch`` when ``rng`` is given)."""
    n = (images.shape[0] // batch_size) * batch_size
    perm = rng.permutation(images.shape[0])[:n] if rng is not None else np.arange(n)
    xs = images[perm].reshape(-1, batch_size, images.shape[1]).astype(dtype)
    ys = labels[perm].reshape(-1, batch_size, labels.shape[1]).astype(dtype)
    return xs, ys
