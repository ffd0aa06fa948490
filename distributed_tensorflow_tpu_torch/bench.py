"""Benchmark of the port: MNIST MLP training throughput on one card.

    python -m distributed_tensorflow_tpu_torch.bench [--impl IMPL]
        [--epochs-per-dispatch E] [--timed-dispatches N]

The counterpart of the repository's ``bench.py``. It prints ONE JSON line,
``{"metric", "value", "unit", "vs_baseline", "impl", "stream_dtype",
"device"}``: training examples per second on one card for the reference
workload (784→100→10 MLP, SGD lr=0.001, batch 100), against the
reference's ~42k examples/s (``BASELINE.md``). Diagnostics go to stderr.

``--impl``:

- ``pallas-epoch`` (default): each dispatch of E epochs is ONE launch of
  the whole-epoch CUDA kernel (``ops/fused_mlp.py`` ``fused_epoch``), with
  the batches staged on the device in bf16;
- ``pallas``: one launch of the per-step CUDA kernel per batch, f32
  batches;
- ``xla``: the plain scanned path (``train/scan.py``, autograd, bf16
  products), one device loop per dispatch, f32 batches.

A failing kernel fails the run: there is no fallback between impls.

Method, as ``bench.py``: the dataset is uploaded once and E shuffled
epochs are gathered into [E*steps, batch, ...] staging on the device; two
warm-up dispatches; then three TWO-POINT pairs, each timing an N-dispatch
and a 4N-dispatch region on the host clock (``--timed-dispatches N``,
default 5), each region ending in
``torch.cuda.synchronize`` and a fetch of its final cost. Per-epoch time
is the pair's difference over the extra epochs (the fixed cost of a region
cancels); the median pair is reported. The fetched costs must be finite
and descend from region to region (every region trains more epochs on the
same staging), or the run is refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.utils.sync import two_point_seconds

BASELINE_EXAMPLES_PER_SEC = 42_000.0
BATCH_SIZE = 100
LEARNING_RATE = 0.001
TIMED_DISPATCHES = 5
IMPLS = ("pallas-epoch", "pallas", "xla")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--impl", choices=IMPLS, default="pallas-epoch")
    p.add_argument("--epochs-per-dispatch", type=int, default=5)
    p.add_argument("--timed-dispatches", type=int, default=TIMED_DISPATCHES)
    return p.parse_args(argv)


def main(argv=None, *, datasets=None, device=None) -> tuple[dict, int]:
    """Run the benchmark; print and return its record, with the number of
    SGD steps it ran (warm-ups included). ``datasets`` defaults to the
    MNIST loader; ``device`` to cuda (raises without one)."""
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets
    from distributed_tensorflow_tpu_torch.device import resolve_device
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    args = parse_args(argv)
    impl, epochs_per_dispatch, timed = args.impl, args.epochs_per_dispatch, args.timed_dispatches
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}  impl: {impl}")
    ds = datasets or read_data_sets("MNIST_data", one_hot=True)
    # pallas-epoch streams the batches in bf16; the other impls take f32.
    stream = "bfloat16" if impl == "pallas-epoch" else "float32"
    sdt = getattr(torch, stream)

    # Stage on the device: upload the flat dataset once, gather E shuffled
    # epochs into the [E*steps, batch, ...] layout there.
    rng = np.random.default_rng(0)
    n_ex = ds.train.num_examples
    steps = n_ex // BATCH_SIZE
    n_used = steps * BATCH_SIZE
    flat_x = torch.from_numpy(ds.train.images).to(dev, sdt)
    flat_y = torch.from_numpy(ds.train.labels).to(dev, sdt)
    perms = np.concatenate([rng.permutation(n_ex)[:n_used] for _ in range(epochs_per_dispatch)])
    perm = torch.from_numpy(perms).to(dev)
    xs = flat_x.index_select(0, perm).reshape(-1, BATCH_SIZE, flat_x.shape[1])
    ys = flat_y.index_select(0, perm).reshape(-1, BATCH_SIZE, flat_y.shape[1])
    del flat_x, flat_y
    log(f"staged {epochs_per_dispatch} epochs x {steps} steps x {BATCH_SIZE} examples "
        f"per dispatch ({(xs.nbytes + ys.nbytes) / 1e6:.0f} MB {stream} on the device)")

    model = MLP()  # bf16 products, f32 accumulation and softmax (xla impl)
    if impl == "xla":
        from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
        from distributed_tensorflow_tpu_torch.ops.optim import sgd
        from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice
        from distributed_tensorflow_tpu_torch.train.scan import make_scanned_train_fn

        opt = sgd(LEARNING_RATE)
        state = SingleDevice(dev).init_state(model, opt, seed=1)
        run_epoch = make_scanned_train_fn(model, cross_entropy, opt)
    else:
        from distributed_tensorflow_tpu_torch.ops import fused_mlp

        log("pallas impls run f32 update math (xla impl runs bf16 products)")
        state = fused_mlp.to_fused(model.init(seed=1, device=dev))
        if impl == "pallas-epoch":
            run_epoch = fused_mlp.make_fused_epoch_fn(
                steps=steps * epochs_per_dispatch, batch_size=BATCH_SIZE,
                learning_rate=LEARNING_RATE, stream_dtype=sdt,
            )
        else:
            run_epoch = fused_mlp.make_fused_scanned_fn(
                batch_size=BATCH_SIZE, learning_rate=LEARNING_RATE
            )

    dispatches = [0]

    def sync_cost(costs) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(costs[-1])

    for i in range(2):
        t0 = time.perf_counter()
        state, costs = run_epoch(state, xs, ys)
        dispatches[0] += 1
        sync_cost(costs)
        log(f"warmup {i + 1}: {time.perf_counter() - t0:.3f}s")

    region_costs = []

    def region(n):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state, costs = run_epoch(state, xs, ys)
        final_cost = sync_cost(costs)
        total = time.perf_counter() - t0
        dispatches[0] += n
        epochs = n * epochs_per_dispatch
        region_costs.append(final_cost)
        log(f"region {len(region_costs)}: {epochs} epochs in {total * 1000:.1f}ms "
            f"({total / epochs * 1000:.3f}ms/epoch raw)  cost={final_cost:.4f}")
        return total

    sec_per_epoch = two_point_seconds(
        lambda: region(timed),
        lambda: region(4 * timed),
        3 * timed * epochs_per_dispatch,
        reps=3,
    )
    log(f"two-point: {sec_per_epoch * 1000:.3f}ms/epoch (median of 3 pairs)")

    # Every region trains more epochs on the same staging, so its final
    # cost (the same last batch each time) must be finite and descend; a
    # flat or rising trajectory means the updates did not happen or the
    # clock did not wait for them.
    tol = 1e-3
    if (
        not all(np.isfinite(c) for c in region_costs)
        or region_costs[-1] >= region_costs[0] - tol
        or any(b > a + tol for a, b in zip(region_costs, region_costs[1:]))
    ):
        raise RuntimeError(f"region costs not finite and descending: {region_costs}")

    examples_per_sec = steps * BATCH_SIZE / sec_per_epoch
    record = {
        "metric": "mnist_mlp_train_examples_per_sec_per_chip",
        "value": round(examples_per_sec, 1),
        "unit": "examples/sec/chip",
        "vs_baseline": round(examples_per_sec / BASELINE_EXAMPLES_PER_SEC, 3),
        "impl": impl,
        "stream_dtype": stream,
        "device": name,
    }
    print(json.dumps(record), flush=True)
    return record, dispatches[0] * steps * epochs_per_dispatch


if __name__ == "__main__":
    main()
