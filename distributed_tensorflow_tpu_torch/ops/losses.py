"""Loss and metric ops: a copy of ``distributed_tensorflow_tpu/ops/losses.py``.

The reference's loss is the numerically naive
``reduce_mean(-reduce_sum(y_ * log(y), axis=1))`` over softmax outputs; the
log input is clamped to 1e-30 so an underflowed probability gives a large
finite loss instead of NaN. Accuracy is mean(argmax(y) == argmax(y_)).
"""

from __future__ import annotations

import torch

LOG_EPS = 1e-30  # clamp for the naive log; far below any f32 softmax output


def cross_entropy(probs: torch.Tensor, labels_one_hot: torch.Tensor) -> torch.Tensor:
    """The reference's naive CE over probabilities, NaN-guarded."""
    logp = torch.log(torch.clamp(probs.float(), min=LOG_EPS))
    return torch.mean(-torch.sum(labels_one_hot * logp, dim=-1))


def stable_cross_entropy(logits: torch.Tensor, labels_one_hot: torch.Tensor) -> torch.Tensor:
    """Logits-based CE (log-softmax), the numerically sound variant."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.mean(-torch.sum(labels_one_hot * logp, dim=-1))


def accuracy(probs_or_logits: torch.Tensor, labels_one_hot: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(probs_or_logits, dim=-1)
    true = torch.argmax(labels_one_hot, dim=-1)
    return torch.mean((pred == true).float())
