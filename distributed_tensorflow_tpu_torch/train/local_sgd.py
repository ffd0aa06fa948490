"""Local SGD / DiLoCo outer loop for the GPT family.

Counterpart of ``distributed_tensorflow_tpu/train/local_sgd.py`` (:120-770).
The reference's async parameter server (``tfdist_between.py``) applies each
worker's update the moment it has it; ``models/gpt.make_lm_async_parts``
carries that to the GPT family as a copy a rank exchanging at the mean. This
module is its communication-reducing form, local SGD with a DiLoCo outer
optimizer:

- each worker runs ``sync_every`` = H **inner** steps with the inner
  optimizer on its own shard of the batch (no traffic between workers);
- the gang then applies ONE **outer** update from the pseudo-gradient
  Δ = θ_start − mean_w(θ_w) through Nesterov momentum (m ← μ·m + Δ;
  θ ← θ_start − η_out·(Δ + μ·m); ``nesterov=False`` is the heavy-ball
  θ ← θ_start − η_out·m), and every copy jumps to the new θ, the next
  round's θ_start.

``outer_lr`` None resolves to N, the worker count (async's
``update_scale=N``: the parameter server applied all N workers' updates in
turn); ``outer_lr=1`` is plain local-SGD averaging. At ``sync_every=1,
outer_lr=1, outer_momentum=0`` the outer update returns the parameter mean
itself (:func:`outer_update`), so the step equals the async exchange
(``make_lm_async_parts(avg_every=1, update_scale=1)``) bit for bit and, for
SGD, the sync data-parallel step up to the order of the sums.

Two levers, both off by default (the outer loop above is then unchanged):

- ``delta_dtype`` "int8" | "fp8": Δ is quantized per tensor
  (``ops/quantized.quantize_tensor``) with an error-feedback residual
  carried in :class:`DiLoCoState`: each round quantizes Δ + r and keeps
  (Δ + r) − Δ̂ for the next (:func:`compress_delta`);
  :func:`delta_payload_nbytes` counts the wire bytes.
- ``overlap``: the delta computed at a boundary goes in flight and is
  applied one round late, while the next H inner steps run; the
  pseudo-gradient is the mean round movement (from where the copies landed
  at the last boundary) and the copies merge toward the stale-applied
  anchor by :data:`OVERLAP_MERGE` instead of jumping to it
  (:func:`outer_round_step`). :func:`streaming_schedule` is the layer-wise
  plan a gang issues the partitions by; the math does not depend on it.

Two engines, one math, both through :func:`_local_inner_step` and
:func:`outer_round_step`:

- :func:`make_lm_diloco_parts`: the gang on a :class:`~parallel.mesh.Mesh`,
  one rank a worker. The rank holds its copy and its inner optimizer state;
  θ_start, momentum, residual and in-flight state are held alike by every
  rank. The exchange is a host ``if`` on the step count: its all-reduces
  run only on round boundaries.
- :func:`make_lm_diloco_vmapped`: the same gang emulated on one device,
  the copies stacked [n, ...]. The JAX package vectorizes the workers with
  ``jax.vmap``; here the body is a loop over the n workers, because the
  flash operator (``dtf::FlashAttention``) has no batching rule for
  ``torch.func.vmap``.

The mailbox gang of the JAX module (``DeltaExchange``, ``stale_limit``) is
a file exchange framed by the checkpoints' CRC records and is ROADMAP A8a;
:func:`staleness_weight`, its weight of a stale delta, is here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from distributed_tensorflow_tpu_torch.models.gpt import _shard, make_lm_train_step
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten


class InFlight(NamedTuple):
    """The overlapped exchange's state (the JAX dict's two keys): ``delta``,
    the outer pseudo-gradient in flight, and ``landing``, the mean point
    the copies landed on at the last boundary. Both dense parameter trees."""

    delta: Any
    landing: Any


class DiLoCoState(NamedTuple):
    """The ``opt_state`` slot of a diloco-mode ``TrainState``.

    ``inner``: the workers' inner optimizer states (this rank's on the mesh
    engine, stacked [n, ...] on the one-device engine; they persist across
    outer rounds). ``theta``: the outer anchor θ_start and ``momentum`` the
    outer Nesterov buffer, parameter trees held alike by every worker.
    ``residual``: the error-feedback residual of ``delta_dtype`` (None when
    that lever is off); ``inflight``: the overlapped exchange's
    :class:`InFlight` (None when ``overlap`` is off)."""

    inner: Any
    theta: Any
    momentum: Any
    residual: Any = None
    inflight: Any = None


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _copy(params):
    return tree_map(torch.clone, params)


def outer_update(theta, mean_params, momentum, *, outer_lr: float, outer_momentum: float,
                 nesterov: bool = True):
    """One outer apply, ``(θ_start, mean_w(θ_w), m) → (θ', m')``: Δ = θ_start −
    mean_params, m' = μ·m + Δ, θ' = θ_start − η_out·(Δ + μ·m') (Nesterov) or
    θ_start − η_out·m' (heavy-ball). At ``outer_lr == 1 and outer_momentum
    == 0`` θ' is ``mean_params`` itself (θ − (θ − mean) = mean, exactly),
    and m' records Δ."""
    mu, eta = float(outer_momentum), float(outer_lr)
    with torch.no_grad():
        delta = tree_map(torch.sub, theta, mean_params)
    if eta == 1.0 and mu == 0.0:
        return mean_params, delta
    return outer_apply(theta, delta, momentum, outer_lr=eta, outer_momentum=mu,
                       nesterov=nesterov)


@torch.no_grad()
def outer_apply(theta, delta, momentum, *, outer_lr: float, outer_momentum: float,
                nesterov: bool = True):
    """The outer optimizer on a given pseudo-gradient, ``(θ_start, Δ, m) →
    (θ', m')``: :func:`outer_update` below its Δ (a compressed Δ̂ or the
    in-flight Δ of an overlapped round goes through the same recurrence)."""
    mu, eta = float(outer_momentum), float(outer_lr)
    new_m = tree_map(lambda m, d: mu * m + d, momentum, delta) if mu != 0.0 else delta
    if nesterov:
        step = tree_map(lambda d, m: d + mu * m, delta, new_m) if mu != 0.0 else delta
    else:
        step = new_m
    return tree_map(lambda t, s: t - eta * s, theta, step), new_m


@torch.no_grad()
def compress_delta(delta, residual, delta_dtype: str):
    """Error-feedback compression of the outer pseudo-gradient: Δ + r
    quantized per tensor (one symmetric f32 scale a tensor, the wire
    format) and back, and the error kept: ``(Δ̂, (Δ + r) − Δ̂)``."""
    from distributed_tensorflow_tpu_torch.ops.quantized import (
        dequantize_tensor,
        quantize_tensor,
    )

    corr = tree_map(torch.add, delta, residual)
    dhat = tree_map(lambda x: dequantize_tensor(*quantize_tensor(x, delta_dtype), x.dtype), corr)
    return dhat, tree_map(torch.sub, corr, dhat)


# How far an overlapped boundary pulls each copy toward the stale-applied
# anchor (0 keeps the local copy, 1 resets it): the JAX package's measured
# streaming-DiLoCo merge. Both engines read this constant.
OVERLAP_MERGE = 0.25


@torch.no_grad()
def _merge_toward(local, target):
    """``(1 − α)·local + α·target``, α = :data:`OVERLAP_MERGE`
    (``target`` broadcasts against a stack of copies)."""
    a = OVERLAP_MERGE
    return tree_map(lambda x, t: (1.0 - a) * x + a * t, local, target)


@torch.no_grad()
def outer_round_step(theta, mean_params, momentum, residual, inflight, *, outer_lr: float,
                     outer_momentum: float, nesterov: bool = True,
                     delta_dtype: str | None = None, overlap: bool = False):
    """ONE outer round under the levers, shared by both engines:
    ``(θ_start, mean_w(θ_w), m, r, f) → (θ', m', r', f')``.

    With both levers off this is :func:`outer_update`. ``delta_dtype``
    passes the pseudo-gradient through :func:`compress_delta`. ``overlap``
    applies the in-flight delta of the previous boundary (zero at the first)
    and puts this round's in its place; this round's pseudo-gradient is the
    mean round movement ``f.landing − mean_w(θ_w)``, and the new landing is
    where the merged copies land on average, ``(1 − α)·mean + α·θ'``."""
    if delta_dtype is None and not overlap:
        theta2, m2 = outer_update(theta, mean_params, momentum, outer_lr=outer_lr,
                                  outer_momentum=outer_momentum, nesterov=nesterov)
        return theta2, m2, residual, inflight
    base = inflight.landing if overlap else theta
    delta = tree_map(torch.sub, base, mean_params)
    if delta_dtype is not None:
        delta, residual = compress_delta(delta, residual, delta_dtype)
    kw = dict(outer_lr=outer_lr, outer_momentum=outer_momentum, nesterov=nesterov)
    if not overlap:
        theta2, m2 = outer_apply(theta, delta, momentum, **kw)
        return theta2, m2, residual, inflight
    theta2, m2 = outer_apply(theta, inflight.delta, momentum, **kw)
    return theta2, m2, residual, InFlight(delta, _merge_toward(mean_params, theta2))


def resolve_outer_lr(outer_lr: float | None, num_workers: int) -> float:
    """``outer_lr`` None → N (the ``update_scale=N`` convention of the async
    modes); the one place that default lives."""
    return float(num_workers) if outer_lr is None else float(outer_lr)


def sync_rounds_between(count0: int, count1: int, sync_every: int) -> int:
    """Outer rounds fired by the steps ``count0 .. count1 − 1`` (step t
    fires iff ``(t + 1) % sync_every == 0``)."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    return count1 // sync_every - count0 // sync_every


def params_nbytes(params) -> int:
    """Bytes of one dense parameter set: the payload of one outer round's
    all-reduce (meta tensors count alike)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(params)))


def delta_payload_nbytes(params, delta_dtype: str | None) -> int:
    """Bytes one outer delta puts on the wire: :func:`params_nbytes` at
    ``delta_dtype=None``, else a byte an element and one f32 scale a
    tensor."""
    if delta_dtype is None:
        return params_nbytes(params)
    if delta_dtype not in ("int8", "fp8"):
        raise ValueError(f"delta_dtype must be None, 'int8', or 'fp8'; got {delta_dtype!r}")
    leaves = tree_leaves(params)
    return int(sum(t.numel() for t in leaves) + 4 * len(leaves))


def staleness_weight(age: int, stale_limit: int) -> float:
    """Weight of a delta ``age`` outer rounds old: 1/(1 + age) within the
    window, 0 past it and for a negative age."""
    if age < 0 or age > stale_limit:
        return 0.0
    return 1.0 / (1.0 + age)


def streaming_schedule(params, sync_every: int, partitions: int | None = None) -> list[dict]:
    """The overlapped exchange's plan: the delta's leaves, in order, split
    greedily into ``partitions`` byte-balanced runs of adjacent leaves
    (default one a leaf, at most H), partition k issued after inner step
    ``k·H // P`` of the next round. ``[{"partition", "leaves", "nbytes",
    "issue_step"}, ...]``."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    leaves = tree_leaves(params)
    if not leaves:
        return []
    if partitions is None:
        partitions = min(len(leaves), sync_every)
    partitions = max(1, min(int(partitions), len(leaves)))
    sizes = [int(t.numel() * t.element_size()) for t in leaves]
    target = sum(sizes) / partitions
    groups: list[list[int]] = [[]]
    acc = 0
    for i, nb in enumerate(sizes):
        remaining_groups = partitions - (len(groups) - 1)
        remaining_leaves = len(sizes) - i
        if (groups[-1] and acc + nb / 2 >= target and remaining_groups > 1
                and remaining_leaves >= remaining_groups):
            groups.append([])
            acc = 0
        groups[-1].append(i)
        acc += nb
    return [{"partition": k, "leaves": len(idxs), "nbytes": int(sum(sizes[i] for i in idxs)),
             "issue_step": (k * sync_every) // len(groups)} for k, idxs in enumerate(groups)]


def _local_inner_step(model, optimizer, ragged: bool):
    """One worker's inner step, ``step(p, o, tokens, lens) -> (p, o,
    loss)``, shared by both engines: the single-device step
    (``models/gpt.make_lm_train_step``), masked over ``lens`` when
    ``ragged``."""
    single = make_lm_train_step(model, optimizer)

    def step(p, o, tokens, lens):
        return single(p, o, tokens, lens if ragged else None)

    return step


def _fresh_outer(params, delta_dtype, overlap):
    """θ_start at ``params`` (a copy), zero momentum, and the levers' state
    from nothing: a zero residual, nothing in flight and every copy landed
    on θ_start (a copy of it, never the same tensors)."""
    return (_copy(params), _zeros(params),
            _zeros(params) if delta_dtype is not None else None,
            InFlight(_zeros(params), _copy(params)) if overlap else None)


def make_lm_diloco_parts(model, optimizer, mesh, *, axis: str = "data", sync_every: int,
                         outer_lr: float | None = None, outer_momentum: float = 0.0,
                         nesterov: bool = True, ragged: bool = False,
                         delta_dtype: str | None = None, overlap: bool = False):
    """The DiLoCo gang on ``mesh``, one rank of ``axis`` a worker (the
    LMTrainer's ``dp_mode="diloco"`` with a mesh). Returns ``(init_state,
    mapped)``:

    - ``init_state(params, opt_state) -> (params, DiLoCoState, count)``:
      this rank's worker copy, its inner state, θ_start = params, zero
      momentum (and the levers' state), count 0;
    - ``mapped(params, dstate, tokens, lens, count) -> (params, dstate,
      loss)``: one inner step on this rank's rows of the global batch
      ``tokens`` [n·B, L] (and ``lens`` when ``ragged``), then, when
      ``(count + 1) % sync_every == 0`` (a host ``if`` on the host count,
      so the all-reduce runs on boundaries only), the outer round on the
      mean of the copies, one all-reduce of a flat bucket. ``loss`` is this
      rank's own; the trainer means it over the ranks where it reads it."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    n = mesh.axis_size(axis)
    eta = resolve_outer_lr(outer_lr, n)
    step_fn = _local_inner_step(model, optimizer, ragged)

    def init_state(params, opt_state):
        return (_copy(params),
                DiLoCoState(tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                     opt_state),
                            *_fresh_outer(params, delta_dtype, overlap)), 0)

    def mapped(params, dstate, tokens, lens, count):
        toks = _shard(tokens, mesh, axis, 0)
        ln = _shard(lens, mesh, axis, 0) if ragged else None
        p, o, loss = step_fn(params, dstate.inner, toks, ln)
        theta, m, r, f = dstate.theta, dstate.momentum, dstate.residual, dstate.inflight
        if (count + 1) % sync_every == 0:
            pbar = tree_unflatten(p, mesh.mean_(tree_leaves(p), axis))
            theta, m, r, f = outer_round_step(
                theta, pbar, m, r, f, outer_lr=eta, outer_momentum=outer_momentum,
                nesterov=nesterov, delta_dtype=delta_dtype, overlap=overlap)
            p = _merge_toward(p, theta) if overlap else _copy(theta)
        return p, DiLoCoState(o, theta, m, r, f), loss

    return init_state, mapped


def _stack(trees):
    """Per-worker trees → one tree stacked [n, ...]; a leaf that is not a
    tensor (a host count every worker shares) kept once."""
    def one(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs):
            raise ValueError(f"host leaves differ between workers: {xs}")
        return xs[0]

    return tree_map(one, *trees)


def _row(tree, w: int):
    """Worker ``w``'s tree of a stacked one."""
    return tree_map(lambda t: t[w] if isinstance(t, torch.Tensor) else t, tree)


def make_lm_diloco_vmapped(model, optimizer, num_workers: int, *, sync_every: int,
                           outer_lr: float | None = None, outer_momentum: float = 0.0,
                           nesterov: bool = True, ragged: bool = False,
                           delta_dtype: str | None = None, overlap: bool = False):
    """The same DiLoCo gang as ONE single-device program (the LMTrainer's
    ``dp_mode="diloco"`` with ``mesh=None`` and ``diloco_workers=n``): the
    copies and inner states stacked [n, ...], the first batch dim of
    ``tokens`` split n ways in worker order (the mesh engine's split), the
    exchange a mean over the stack. The JAX package maps the workers with
    ``jax.vmap``; the port loops over them, because the flash operator
    (``dtf::FlashAttention``) has no batching rule for ``torch.func.vmap``.
    Same contract as :func:`make_lm_diloco_parts`; ``loss`` is the mean of
    the workers' losses."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    n = num_workers
    eta = resolve_outer_lr(outer_lr, n)
    step_fn = _local_inner_step(model, optimizer, ragged)

    def init_state(params, opt_state):
        return (_stack([params] * n),
                DiLoCoState(_stack([opt_state] * n), *_fresh_outer(params, delta_dtype, overlap)),
                0)

    def mapped(params, dstate, tokens, lens, count):
        b, l = tokens.shape
        if b % n:
            raise ValueError(f"batch {b} must divide over {n} emulated workers")
        rows = b // n
        out = [step_fn(_row(params, w), _row(dstate.inner, w), tokens[w * rows:(w + 1) * rows],
                       lens[w * rows:(w + 1) * rows] if ragged else None) for w in range(n)]
        p, inner = _stack([x[0] for x in out]), _stack([x[1] for x in out])
        loss = torch.stack([x[2] for x in out]).mean()
        theta, m, r, f = dstate.theta, dstate.momentum, dstate.residual, dstate.inflight
        if (count + 1) % sync_every == 0:
            with torch.no_grad():
                pbar = tree_map(lambda x: x.sum(0) / n, p)
            theta, m, r, f = outer_round_step(
                theta, pbar, m, r, f, outer_lr=eta, outer_momentum=outer_momentum,
                nesterov=nesterov, delta_dtype=delta_dtype, overlap=overlap)
            p = _merge_toward(p, theta) if overlap else _stack([theta] * n)
        return p, DiLoCoState(inner, theta, m, r, f), loss

    return init_state, mapped
