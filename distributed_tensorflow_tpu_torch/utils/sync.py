"""Trustworthy execution barriers for timing code.

Counterpart of ``distributed_tensorflow_tpu/utils/sync.py``. CUDA launches
are asynchronous: a call returns once its kernels are queued, so a clock
read after it times the enqueue. The barrier that provably waits for the
card is a device-to-host copy of a value that depends on the work being
timed (``.cpu()`` waits for the stream that produces it). The reference's
timing (AvgTime / Total Time around ``sess.run``, ``tfdist_between.py:92-
110``) had its fetch built in.
"""

from __future__ import annotations

import time

import torch
from torch.utils._pytree import tree_leaves


def timed_fetch(fn, *args):
    """Run ``fn(*args)`` and return ``(seconds, result)``, the clock read
    AFTER a one-element device-to-host fetch of the result's first tensor:
    an element of the output exists only once the work has run."""
    t0 = time.perf_counter()
    out = fn(*args)
    leaf = next(x for x in tree_leaves(out) if isinstance(x, torch.Tensor))
    float(leaf.reshape(-1)[0].float())
    return time.perf_counter() - t0, out


def two_point_seconds(time_short, time_long, span: int, reps: int = 5) -> float:
    """Per-unit seconds by the two-point method: call ``time_short()`` and
    ``time_long()`` (each a whole timed dispatch whose clock reads after a
    value fetch) and divide the difference by ``span``, the extra units
    the long one runs, so a fixed per-dispatch cost cancels. The median of
    ``reps`` pairs; clamped to 1e-12 (a result that small means the span
    is below the noise, not that the work is free)."""
    deltas = []
    for _ in range(reps):
        t_short = time_short()
        t_long = time_long()
        deltas.append((t_long - t_short) / span)
    deltas.sort()
    return max(deltas[len(deltas) // 2], 1e-12)


def d2h_barrier(tree) -> None:
    """Block until every computation ``tree`` depends on has run, by copying
    each tensor of it on a device to the host (every one: the leaves may
    come from independent streams of work). Prefer fetching a value you
    need anyway; use this when the timed code produces nothing the caller
    wants on the host."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            leaf.cpu()
