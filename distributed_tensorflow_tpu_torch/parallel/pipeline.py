"""Pipeline parallelism: the GPipe schedule over a ``stage`` mesh axis.

Counterpart of ``distributed_tensorflow_tpu/parallel/pipeline.py``
(:28-87). Each rank of the stage axis holds one stage's parameters; M
microbatches flow stage to stage over one :meth:`~parallel.mesh.Mesh.ring_permute`
hop a tick, so after the fill every stage computes at once: M + S − 1 ticks.
At tick t, stage s works on microbatch t − s: stage 0 takes it from the
input, the others from the carry the previous stage hopped on; the last
stage banks each finished microbatch. The banked output is summed over the
stage axis (``ops/collectives.reduce_from``: every stage gets it, and its
gradient passes as it is, since every stage then uses it alike). The input
enters through ``copy_to`` (its gradient summed over the axis), because
only stage 0 reads it: the embedding's gradient through the pipeline exists
on stage 0 alone and must reach every stage's replica.

JAX gets the backward from autodiff through its ``fori_loop`` of
``ppermute`` hops. Here the schedule is one ``torch.autograd.Function``
whose backward replays the ticks in reverse, each hop inverted: every rank
runs every hop, forward and backward, in the same order, whether or not
its stage computes on that tick (a rank whose microbatch index is out of
range skips the stage's compute, whose output JAX masks to zero, but never
the hop). A tick's stage forward keeps its autograd graph for the
backward, so a stage body under ``torch.utils.checkpoint`` recomputes its
group a tick there; the hops stay outside it. The last tick's hop carries
nothing any stage reads and is left out on every rank, forward and
backward alike.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_tensorflow_tpu_torch.ops.collectives import copy_to, reduce_from
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_unflatten
from distributed_tensorflow_tpu_torch.parallel.mesh import permute_raw


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] → [M, B/M, ...]."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"a batch of {b} rows does not split into {num_microbatches} "
                         "microbatches")
    return x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """``y_mb = f_{S-1}(...f_1(f_0(x_mb)))`` for every microbatch.

    - ``stage_fn(params, x) -> y``: one stage's computation, x and y of one
      shape;
    - ``stage_params``: this rank's stage (a tree of tensors whose leaves
      carry a leading [1, ...]: its block of the [S, ...] stack split over
      ``axis`` of ``mesh``);
    - ``x_microbatches``: [M, b, ...], the same on every rank of the axis.

    Returns the [M, b, ...] outputs on every rank. A collective of the
    axis; differentiable in ``x_microbatches`` and ``stage_params``."""
    leaves = tree_leaves(stage_params)
    x = copy_to(x_microbatches, mesh, axis)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        out = _Pipeline.apply(stage_fn, stage_params, mesh, axis, x, *leaves)
    else:
        out = _schedule(stage_fn, stage_params, leaves, x, mesh, axis, None)
    return reduce_from(out, mesh, axis)


def _schedule(stage_fn, like, leaves, x, mesh, axis, saved):
    """The forward ticks: the last stage's banked outputs [M, b, ...]
    (zeros on the other stages). With ``saved`` (a dict), each computing
    tick's (input, output) with the output's graph over ``leaves`` is kept
    under its tick for the backward."""
    s, my = mesh.axis_size(axis), mesh.axis_index(axis)
    m = x.shape[0]
    params = tree_unflatten(like, leaves)
    carry, out = torch.zeros_like(x[0]), torch.zeros_like(x)
    for t in range(m + s - 1):
        mb = t - my
        if 0 <= mb < m:
            inp = x[mb] if my == 0 else carry
            if saved is None:
                y = stage_fn(params, inp)
            else:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(params, inp)
                saved[t] = (inp, y)
                y = y.detach()
            if my == s - 1:
                out[mb] = y
        else:
            y = torch.zeros_like(carry)
        if t < m + s - 2:
            (carry,) = permute_raw(mesh, axis, [y.to(x.dtype)], 1)
    return out


class _Pipeline(torch.autograd.Function):
    """The schedule forward; backward, the ticks in reverse: the gradient
    of a tick's hop comes back over the inverse hop, the stage's graph of
    that tick takes it (plus the output's gradient where the last stage
    banked the microbatch), and the input's part goes to the previous
    tick's hop, or (stage 0) to the microbatch's gradient."""

    @staticmethod
    def forward(ctx, stage_fn, like, mesh, axis, x, *leaves):
        with torch.enable_grad():
            blk = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        saved: dict = {}
        out = _schedule(stage_fn, like, blk, x, mesh, axis, saved)
        ctx.mesh, ctx.axis, ctx.blk, ctx.saved = mesh, axis, blk, saved
        ctx.x_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g_out):
        mesh, axis, blk, saved = ctx.mesh, ctx.axis, ctx.blk, ctx.saved
        s, my = mesh.axis_size(axis), mesh.axis_index(axis)
        g_x = g_out.new_zeros(ctx.x_shape)
        m = g_x.shape[0]
        want = [b for b in blk if b.requires_grad]
        g_blk = [None] * len(want)
        g_next = torch.zeros_like(g_x[0])  # the gradient of the carry of tick t + 1
        for t in reversed(range(m + s - 1)):
            if t < m + s - 2:
                (g_y,) = permute_raw(mesh, axis, [g_next], -1)
            else:
                g_y = torch.zeros_like(g_next)
            g_next = torch.zeros_like(g_y)
            if t not in saved:
                continue
            mb = t - my
            inp, y = saved.pop(t)
            if my == s - 1:
                g_y = g_y + g_out[mb]
            grads = torch.autograd.grad(y, [inp, *want], g_y.to(y.dtype), allow_unused=True)
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    g_blk[i] = g if g_blk[i] is None else g_blk[i] + g
            if my == 0:
                g_x[mb] += grads[0]
            else:
                g_next = grads[0].to(g_next.dtype)
        it = iter(g_blk)
        g_leaves = [next(it) if b.requires_grad else None for b in blk]
        ctx.saved = ctx.blk = None
        return (None, None, None, None, g_x, *g_leaves)
