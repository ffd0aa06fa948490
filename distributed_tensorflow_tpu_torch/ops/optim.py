"""Optimizers of the port, in optax's arithmetic.

Counterpart of ``distributed_tensorflow_tpu/ops/optim.py`` ``sgd`` and
``make``: plain SGD (the reference's ``tf.train.GradientDescentOptimizer
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
fresh tree of the params' type (NamedTuples, nested or flat). SGD keeps
no state and also has ``apply(params, grads)``, which the MLP paths call.
The state's step count stays a tensor on the params' device, so an update
never syncs with the host. Schedules, warmup, clipping and accumulation
are not ported yet (ROADMAP A4 "Left").
"""

from __future__ import annotations

from typing import Any, NamedTuple

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
            return type(node)(*(build(sub) for sub in node))
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), as a tree of ``tree``'s shape."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(
        tree, [fn(*args) for args in zip(tree_leaves(tree), *others)]
    )


class SGD(NamedTuple):
    """``p ← p − lr·g`` (optax's ``p + (−lr)·g``, the same rounding)."""

    learning_rate: float

    def apply(self, params, grads):
        return type(params)(*(p - self.learning_rate * g for p, g in zip(params, grads)))

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return tree_map(lambda p, g: p + (-self.learning_rate) * g, params, grads), state


class MomentumState(NamedTuple):
    trace: Any  # a tree of the params' shape (optax ``TraceState.trace``)


class Momentum(NamedTuple):
    """optax ``sgd(lr, momentum)``: ``t = g + momentum·t``, ``p += −lr·t``."""

    learning_rate: float
    momentum: float = 0.9

    def init(self, params) -> MomentumState:
        return MomentumState(tree_map(torch.zeros_like, params))

    def update(self, grads, state: MomentumState, params):
        trace = tree_map(lambda g, t: g + self.momentum * t, grads, state.trace)
        new = tree_map(lambda p, t: p + (-self.learning_rate) * t, params, trace)
        return new, MomentumState(trace)


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the step count (int32 scalar tensor) and
    the first and second moments, trees of the params' shape."""

    count: torch.Tensor
    mu: Any
    nu: Any


class Adam(NamedTuple):
    """optax ``adam`` (``weight_decay=None``) or ``adamw``."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float | None = None

    def init(self, params) -> AdamState:
        dev = tree_leaves(params)[0].device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
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

        def step(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2 + self.eps_root) + self.eps)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p
            return p + (-self.learning_rate) * u

        return tree_map(step, params, mu, nu), AdamState(count, mu, nu)


def sgd(learning_rate: float = 0.001) -> SGD:
    """The reference optimizer: vanilla SGD, lr=0.001."""
    return SGD(float(learning_rate))


def momentum(learning_rate: float, momentum: float = 0.9) -> Momentum:
    return Momentum(float(learning_rate), float(momentum))


def adam(learning_rate: float, **kw) -> Adam:
    return Adam(float(learning_rate), **kw)


def adamw(learning_rate: float, weight_decay: float = 1e-4, **kw) -> Adam:
    return Adam(float(learning_rate), weight_decay=float(weight_decay), **kw)


def make(name: str, learning_rate: float):
    """The optimizer ``TrainConfig.optimizer`` names."""
    registry = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}
    if name not in registry:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(registry)}")
    return registry[name](learning_rate)
