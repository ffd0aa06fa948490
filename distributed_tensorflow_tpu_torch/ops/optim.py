"""Optimizers of the port, in optax's arithmetic.

Counterpart of ``distributed_tensorflow_tpu/ops/optim.py`` ``sgd``,
``make``, ``schedule`` (:49), ``accumulate`` (:91) and ``clip`` (:108):
plain SGD (the reference's ``tf.train.GradientDescentOptimizer
(0.001)``), momentum (``optax.sgd(lr, momentum=0.9)``: the trace
``t = g + 0.9·t``, no Nesterov), Adam and AdamW (``optax.adam`` /
``optax.adamw``). Each computes optax's update in optax's order, not
``torch.optim``'s:

- Adam: ``mu = (1−b1)·g + b1·mu``, ``nu = (1−b2)·g² + b2·nu``, then
  ``(mu/(1−b1ᵗ)) / (sqrt(nu/(1−b2ᵗ) + eps_root) + eps)``;
- AdamW adds ``weight_decay·p`` to that update;
- every update is scaled by ``−lr`` and added to the parameter.

An optimizer is a small immutable object. ``init(params)`` gives its state
and ``update(grads, state, params)`` the new ``(params, state)``, each a
fresh tree of the params' type (NamedTuples, nested or flat). Constant-lr
SGD keeps no state. Every learning rate is a float or a schedule from
:func:`schedule`, a function of the optimizer state's step count, which
stays a tensor on the params' device, so an update never syncs with the
host. The wrappers compose as the JAX launcher composes them,
``accumulate(clip(make(name, schedule(...)), max_norm), every)``:

- :func:`clip`: optax's ``clip_by_global_norm`` ahead of the optimizer;
- :func:`accumulate`: optax's ``MultiSteps``, a running mean of the
  gradients over ``every`` calls, the inner update run on the last only;
  the other calls leave the parameters as they were, bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, NamedTuple

import torch


def tree_leaves(tree) -> list:
    """The tensors of a tree of (nested) tuples, depth first."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in :func:`tree_leaves`'s
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, tuple):
            subs = [build(sub) for sub in node]
            return type(node)(*subs) if hasattr(node, "_fields") else type(node)(subs)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), as a tree of ``tree``'s shape."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(
        tree, [fn(*args) for args in zip(tree_leaves(tree), *others)]
    )


def _device(params):
    return tree_leaves(params)[0].device


def _zero_count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _lr_at(learning_rate, count):
    """The learning rate at the state's ``count`` (before the update's
    increment, as optax's ``scale_by_schedule`` reads it): the float
    itself, or the schedule's f32 tensor on the count's device."""
    return learning_rate(count) if callable(learning_rate) else learning_rate


class ScheduleState(NamedTuple):
    """optax ``ScaleByScheduleState``: the updates taken so far."""

    count: torch.Tensor


class SGD(NamedTuple):
    """``p ← p + (−lr)·g`` (optax's ``sgd``). A constant rate keeps no
    state; a schedule keeps the step count it is evaluated on."""

    learning_rate: float | Callable

    def init(self, params):
        return ScheduleState(_zero_count(params)) if callable(self.learning_rate) else ()

    def update(self, grads, state, params):
        if not callable(self.learning_rate):
            return tree_map(lambda p, g: p + (-self.learning_rate) * g, params, grads), state
        neg = -self.learning_rate(state.count)
        return tree_map(lambda p, g: p + neg * g, params, grads), ScheduleState(state.count + 1)


class MomentumState(NamedTuple):
    trace: Any  # a tree of the params' shape (optax ``TraceState.trace``)
    count: torch.Tensor  # updates taken (the schedule's step)


class Momentum(NamedTuple):
    """optax ``sgd(lr, momentum)``: ``t = g + momentum·t``, ``p += −lr·t``."""

    learning_rate: float | Callable
    momentum: float = 0.9

    def init(self, params) -> MomentumState:
        return MomentumState(tree_map(torch.zeros_like, params), _zero_count(params))

    def update(self, grads, state: MomentumState, params):
        trace = tree_map(lambda g, t: g + self.momentum * t, grads, state.trace)
        neg = -_lr_at(self.learning_rate, state.count)
        new = tree_map(lambda p, t: p + neg * t, params, trace)
        return new, MomentumState(trace, state.count + 1)


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the step count (int32 scalar tensor) and
    the first and second moments, trees of the params' shape."""

    count: torch.Tensor
    mu: Any
    nu: Any


class Adam(NamedTuple):
    """optax ``adam`` (``weight_decay=None``) or ``adamw``."""

    learning_rate: float | Callable
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float | None = None

    def init(self, params) -> AdamState:
        return AdamState(
            count=_zero_count(params),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(self, grads, state: AdamState, params):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        t = count.float()
        c1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        # optax chains scale_by_adam, add_decayed_weights and the rate, so
        # a schedule scales the decay too.
        neg = -_lr_at(self.learning_rate, state.count)

        def step(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2 + self.eps_root) + self.eps)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p
            return p + neg * u

        return tree_map(step, params, mu, nu), AdamState(count, mu, nu)


def _rate(learning_rate):
    return learning_rate if callable(learning_rate) else float(learning_rate)


def sgd(learning_rate=0.001) -> SGD:
    """The reference optimizer: vanilla SGD, lr=0.001."""
    return SGD(_rate(learning_rate))


def momentum(learning_rate, momentum: float = 0.9) -> Momentum:
    return Momentum(_rate(learning_rate), float(momentum))


def adam(learning_rate, **kw) -> Adam:
    return Adam(_rate(learning_rate), **kw)


def adamw(learning_rate, weight_decay: float = 1e-4, **kw) -> Adam:
    return Adam(_rate(learning_rate), weight_decay=float(weight_decay), **kw)


def make(name: str, learning_rate):
    """The optimizer ``TrainConfig.optimizer`` names; ``learning_rate`` is a
    float or a schedule (:func:`schedule`)."""
    registry = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}
    if name not in registry:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(registry)}")
    return registry[name](learning_rate)


# -- learning-rate schedules (optax's arithmetic on an int32 step count) -----


class Cosine(NamedTuple):
    """optax ``cosine_decay_schedule(init_value, decay_steps)``."""

    init_value: float
    decay_steps: int

    def __call__(self, count):
        t = torch.clamp(count, max=self.decay_steps).float()
        decay = 0.5 * (1 + torch.cos(math.pi * t / float(self.decay_steps)))
        return self.init_value * decay


class Linear(NamedTuple):
    """optax ``linear_schedule(init_value, end_value, transition_steps)``."""

    init_value: float
    end_value: float
    transition_steps: int

    def __call__(self, count):
        frac = 1 - torch.clamp(count, 0, self.transition_steps) / self.transition_steps
        return (self.init_value - self.end_value) * frac + self.end_value


class Exponential(NamedTuple):
    """optax ``exponential_decay(init_value, transition_steps, decay_rate)``."""

    init_value: float
    transition_steps: int
    decay_rate: float

    def __call__(self, count):
        p = count / self.transition_steps
        decayed = self.init_value * torch.pow(torch.tensor(self.decay_rate, device=count.device), p)
        return torch.where(count <= 0, self.init_value, decayed)


class Warmup(NamedTuple):
    """optax ``join_schedules([linear ramp 0 → peak], [warmup_steps])``: the
    ramp below ``warmup_steps``, then ``peak`` at ``count − warmup_steps``
    (a float peak is held)."""

    ramp: Linear
    peak: Any
    warmup_steps: int

    def __call__(self, count):
        after = count - self.warmup_steps
        peak = self.peak(after) if callable(self.peak) else self.peak
        return torch.where(count < self.warmup_steps, self.ramp(count), peak)


def schedule(name: str | None, learning_rate: float, total_steps: int, *,
             warmup_steps: int = 0):
    """The learning rate ``TrainConfig.lr_schedule`` names (the JAX
    ``optim.schedule``): ``None``/"constant" return the float unchanged, so
    the constant path stays bitwise; "cosine", "linear" (to 0) and
    "exponential" (to 1% of the peak) decay over ``max(1, total_steps −
    warmup_steps)`` steps after a linear warmup from 0. ``total_steps``
    counts optimizer applies (under :func:`accumulate`, one per ``every``
    calls). A schedule maps the state's device step count to an f32 tensor."""
    decay_steps = max(1, total_steps - warmup_steps)
    lr = float(learning_rate)
    if name in (None, "constant"):
        base = lr
    elif name == "cosine":
        base = Cosine(lr, decay_steps)
    elif name == "linear":
        base = Linear(lr, 0.0, decay_steps)
    elif name == "exponential":
        base = Exponential(lr, decay_steps, 0.01)
    else:
        raise ValueError(
            f"unknown lr schedule {name!r}; use constant/cosine/linear/exponential"
        )
    if warmup_steps > 0:
        return Warmup(Linear(0.0, lr, warmup_steps), base, warmup_steps)
    return base


# -- clipping and accumulation ----------------------------------------------


def sum_of_squares(grads) -> torch.Tensor:
    return sum(torch.sum(g * g) for g in tree_leaves(grads))


# The sum of squares ``global_norm`` takes: a strategy whose gradients are
# shards of the whole (ZeRO, parallel/fsdp.py) swaps in one that sums over
# every rank's shard for the length of its update (:func:`squares_over`).
_SQUARES = [sum_of_squares]


@contextlib.contextmanager
def squares_over(fn):
    """Within the block, :func:`global_norm` sums squares with ``fn``."""
    _SQUARES.append(fn)
    try:
        yield
    finally:
        _SQUARES.pop()


def global_norm(grads) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum over leaves of each leaf's
    sum of squares."""
    return torch.sqrt(_SQUARES[-1](grads))


class Clip(NamedTuple):
    """optax ``chain(clip_by_global_norm(max_norm), inner)``: the gradients
    scaled by ``max_norm / norm`` (as ``(g / norm) · max_norm``) unless
    ``norm < max_norm``; the state is the inner optimizer's."""

    inner: Any
    max_norm: float

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        norm = global_norm(grads)
        keep = norm < self.max_norm
        clipped = tree_map(
            lambda g: torch.where(keep, g, (g / norm.to(g.dtype)) * self.max_norm), grads
        )
        return self.inner.update(clipped, state, params)


class MultiStepsState(NamedTuple):
    """optax ``MultiStepsState`` (without the skip state)."""

    mini_step: int  # calls since the last apply, on the host
    gradient_step: torch.Tensor  # applies so far (int32)
    inner_opt_state: Any
    acc_grads: Any  # running mean of this window's gradients


class Accumulate(NamedTuple):
    """optax ``MultiSteps(inner, every_k_schedule=every)``: ``acc += (g −
    acc) / (k + 1)``; on the ``every``-th call the inner update runs on
    ``acc`` and ``acc`` resets, the other calls return the parameters and
    the inner state as they were. The mini-step advances by one a call
    whatever the data, so it is a host int and the choice (optax's
    ``lax.cond``) reads nothing from the device."""

    inner: Any
    every: int

    def init(self, params) -> MultiStepsState:
        return MultiStepsState(
            0, _zero_count(params), self.inner.init(params), tree_map(torch.zeros_like, params)
        )

    def update(self, grads, state: MultiStepsState, params):
        k = state.mini_step
        acc = tree_map(lambda g, a: a + (g - a) / (k + 1), grads, state.acc_grads)
        if k + 1 < self.every:
            return params, state._replace(mini_step=k + 1, acc_grads=acc)
        new_params, new_inner = self.inner.update(acc, state.inner_opt_state, params)
        return new_params, MultiStepsState(
            0, state.gradient_step + 1, new_inner, tree_map(torch.zeros_like, acc)
        )


def clip(optimizer, max_norm: float):
    """Global-norm clipping ahead of ``optimizer``; ``max_norm <= 0``
    returns the optimizer unchanged."""
    if max_norm <= 0:
        return optimizer
    return Clip(optimizer, float(max_norm))


def accumulate(optimizer, every: int):
    """Average the gradients over ``every`` calls and apply once;
    ``every <= 1`` returns the optimizer unchanged."""
    if every <= 1:
        return optimizer
    return Accumulate(optimizer, int(every))
