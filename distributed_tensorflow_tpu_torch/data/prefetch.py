"""Host→device batch prefetching for the eager per-batch loop.

Counterpart of ``distributed_tensorflow_tpu/data/prefetch.py``: ``depth``
batches are placed ahead of the step that consumes them, through the
strategy's ``prepare_batch`` (this rank's rows of each global batch, on
its device). The batch order is the unprefetched loop's; only when each
batch is placed changes. (The scanned and whole-run paths stage the
arrays on the device once and do not need this.)
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator


def prefetch_batches(
    next_batch: Callable[[int], tuple],
    batch_size: int,
    steps: int,
    place: Callable[..., tuple],
    depth: int = 2,
) -> Iterator[tuple]:
    """Yield ``steps`` placed batches with ``depth`` in flight:
    ``next_batch(batch_size)`` produces host arrays, ``place(*batch)``
    puts one on the device."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    queue: deque[tuple] = deque()
    for _ in range(min(depth, steps)):
        queue.append(place(*next_batch(batch_size)))
    for i in range(steps):
        batch = queue.popleft()
        if i + depth < steps:
            queue.append(place(*next_batch(batch_size)))
        yield batch
