"""Whole-run training: every epoch, shuffle and eval in one call.

Counterpart of ``distributed_tensorflow_tpu/train/compiled_run.py``. The
JAX package compiles the run into one nested ``lax.scan``; here it is one
Python call whose device work never waits on the host: the epoch shuffle
is a device permutation (``torch.randperm`` with the caller's device
generator), each step gathers its batch on the device, the per-epoch test
accuracy is computed on the device, and the caller fetches the costs
``[epochs, steps]`` and accuracies ``[epochs]`` once at the end.

Semantics vs the eager loop: the same update rule, batch size and update
count. The shuffle comes from torch's generator instead of the host numpy
stream, so batch composition differs the way two seeds differ. With
``shuffle=False`` batches are taken in dataset order every epoch.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState, sgd_step


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
):
    """``fn(state, train_x, train_y, test_x, test_y, generator) -> (state,
    {"costs": [epochs, steps], "accuracy": [epochs]})``, results on the
    device. The step count is ``len(train_x) // batch_size`` (the tail is
    dropped, as the reference's ``int(num_examples/batch_size)``). The JAX
    package's ``steps_per_epoch`` (the per-worker epoch of data
    parallelism) comes with ROADMAP A6."""

    def run(state: TrainState, train_x, train_y, test_x, test_y, generator):
        steps = train_x.shape[0] // batch_size
        need = steps * batch_size
        dev = train_x.device
        params = state.params
        costs = torch.empty((epochs, steps), dtype=torch.float32, device=dev)
        accs = torch.empty(epochs, dtype=torch.float32, device=dev)
        for e in range(epochs):
            perm = wrapped_epoch_perm(
                generator, domain=need, need=need, k=1, shuffle=shuffle, device=dev
            ).reshape(steps, batch_size)
            for i in range(steps):
                x = train_x.index_select(0, perm[i])
                y = train_y.index_select(0, perm[i])
                params, costs[e, i] = sgd_step(model, loss_fn, optimizer, params, x, y)
            with torch.no_grad():
                accs[e] = losses_lib.accuracy(model.apply(params, test_x), test_y)
        state = TrainState(params, state.opt_state, state.step + epochs * steps)
        return state, {"costs": costs, "accuracy": accs}

    return run
