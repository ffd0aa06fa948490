"""Whole-run training: every epoch, shuffle and eval in one call.

Counterpart of ``distributed_tensorflow_tpu/train/compiled_run.py``. The
JAX package compiles the run into one nested ``lax.scan``; here it is one
Python call whose device work never waits on the host: the epoch shuffle
is a device permutation (``torch.randperm`` with the caller's device
generator), each step gathers its batch on the device, the per-epoch test
accuracy is computed on the device, and the caller fetches the costs
``[epochs, steps]`` and accuracies ``[epochs]`` once at the end.

Each epoch is a call of the one device loop (``train/scan.py``
``device_loop``, through the indexed scanned epoch). Semantics vs the
eager loop: the same update rule (any optimizer, its state carried), batch
size and update count. The shuffle comes from torch's generator instead of the host numpy
stream, so batch composition differs the way two seeds differ. With
``shuffle=False`` batches are taken in dataset order every epoch.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState
from distributed_tensorflow_tpu_torch.train.scan import make_indexed_scanned_train_fn


def wrapped_epoch_perm(generator, *, domain: int, need: int, k: int, shuffle: bool, device):
    """One epoch's index stream over ``domain`` device-resident rows:
    ``need`` indices from ``k`` fresh permutations concatenated (the device
    analog of ``DataSet.next_batch``'s tail-carry reshuffle; ``k == 1`` is
    the plain one-permutation epoch), or dataset order tiled when not
    shuffling. Shared by the generic and the kernel whole-run paths."""
    if not shuffle:
        return torch.arange(domain, device=device).repeat(k)[:need]
    perms = [torch.randperm(domain, generator=generator, device=device) for _ in range(k)]
    return (perms[0] if k == 1 else torch.cat(perms))[:need]


def make_compiled_run_fn(
    model,
    loss_fn,
    optimizer,
    *,
    batch_size: int,
    epochs: int,
    shuffle: bool = True,
    steps_per_epoch: int | None = None,
    epoch_fn=None,
    eval_fn=None,
):
    """``fn(state, train_x, train_y, test_x, test_y, generator) -> (state,
    {"costs": [epochs, steps], "accuracy": [epochs]})``, results on the
    device; ``batch_size`` is the GLOBAL batch. The step count is
    ``len(train_x) // batch_size`` (the tail is dropped, as the reference's
    ``int(num_examples/batch_size)``), or ``steps_per_epoch`` (the
    reference's per-worker epoch: the index stream then wraps over fresh
    permutations of the whole dataset).

    ``epoch_fn(state, train_x, train_y, idxs [steps, batch]) -> (state,
    costs)`` runs an epoch (default: the one-device indexed scan) and
    ``eval_fn(state, test_x, test_y)`` its accuracy (default: the state's
    parameters); a strategy passes its own, so each rank takes its columns
    of the same permutation (every rank's generator is seeded alike)."""

    epoch_fn = epoch_fn or make_indexed_scanned_train_fn(model, loss_fn, optimizer)
    if eval_fn is None:
        @torch.no_grad()
        def eval_fn(state, x, y):
            return losses_lib.accuracy(model.apply(state.params, x), y)

    def run(state: TrainState, train_x, train_y, test_x, test_y, generator):
        steps = train_x.shape[0] // batch_size if steps_per_epoch is None else steps_per_epoch
        need = steps * batch_size
        domain = need if steps_per_epoch is None else train_x.shape[0]
        k = (need + domain - 1) // domain if need else 1
        dev = train_x.device
        costs = torch.empty((epochs, steps), dtype=torch.float32, device=dev)
        accs = torch.empty(epochs, dtype=torch.float32, device=dev)
        for e in range(epochs):
            perm = wrapped_epoch_perm(
                generator, domain=domain, need=need, k=k, shuffle=shuffle, device=dev
            ).reshape(steps, batch_size)
            state, costs[e] = epoch_fn(state, train_x, train_y, perm)
            accs[e] = eval_fn(state, test_x, test_y)
        return state, {"costs": costs, "accuracy": accs}

    return run
