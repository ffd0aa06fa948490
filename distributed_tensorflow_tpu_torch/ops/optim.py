"""Optimizers of the port: plain SGD, the reference's optimizer
(``tf.train.GradientDescentOptimizer(0.001)``; JAX ``ops/optim.py`` ``sgd``).

An optimizer here is a small object whose ``apply(params, grads)`` returns
the updated parameters as a new tuple of the same type; plain SGD keeps no
state. The JAX package's momentum, Adam/AdamW, schedules, clipping and
accumulation are not ported yet (ROADMAP A4).
"""

from __future__ import annotations

from typing import NamedTuple

NOT_PORTED = ("momentum", "adam", "adamw")


class SGD(NamedTuple):
    """``p ← p − lr·g`` (optax's ``p + (−lr)·g``, the same rounding)."""

    learning_rate: float

    def apply(self, params, grads):
        return type(params)(*(p - self.learning_rate * g for p, g in zip(params, grads)))


def sgd(learning_rate: float = 0.001) -> SGD:
    """The reference optimizer: vanilla SGD, lr=0.001."""
    return SGD(float(learning_rate))


def make(name: str, learning_rate: float) -> SGD:
    """The optimizer ``TrainConfig.optimizer`` names; only ``sgd`` is ported."""
    if name == "sgd":
        return sgd(learning_rate)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A4); the port has 'sgd'"
        )
    raise ValueError(f"unknown optimizer {name!r}; the JAX package has {['sgd', *NOT_PORTED]}")
