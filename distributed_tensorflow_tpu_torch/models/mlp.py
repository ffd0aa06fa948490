"""The reference workload: a 2-layer sigmoid/softmax MLP.

Counterpart of ``distributed_tensorflow_tpu/models/mlp.py``::

    y = softmax( sigmoid(x @ W1 + b1) @ W2 + b2 )
    x: [B, 784]   W1: [784, 100] ~ N(0, 1)   b1: zeros(100)
                  W2: [100, 10]  ~ N(0, 1)   b2: zeros(10)

Rounding follows the JAX model: both products take operands cast to
``compute_dtype`` (bf16 by default) and accumulate in f32, the bias adds,
sigmoid and softmax run in f32. A bf16 product is written as the f32
product of bf16-rounded operands, which is what ``jnp.dot(...,
preferred_element_type=f32)`` computes; a bf16 ``matmul`` would round its
output to bf16 as well.

Init draws from an explicit CPU ``torch.Generator`` seeded with ``seed``,
so the same seed gives the same weights on every device. It is not the JAX
PRNG's draw: parity with the JAX model is distributional (the tests hand
both the same numpy weights).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_tensorflow_tpu_torch.device import resolve_device


class MLPParams(NamedTuple):
    w1: torch.Tensor  # [in_dim, hidden]
    b1: torch.Tensor  # [hidden]
    w2: torch.Tensor  # [hidden, out]
    b2: torch.Tensor  # [out]


def dot(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w`` of operands rounded to ``compute_dtype``, accumulated in f32."""
    if compute_dtype == torch.float32:
        return x.float() @ w.float()
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


class MLP:
    """The reference's 784→100→10 MLP as init/apply functions."""

    def __init__(
        self,
        in_dim: int = 784,
        hidden_dim: int = 100,
        out_dim: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        self.in_dim = in_dim
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim
        self.compute_dtype = compute_dtype

    def init(self, seed: int = 1, device=None) -> MLPParams:
        """N(0,1) weights, zero biases, on ``device`` (default cuda)."""
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        w1 = torch.randn(self.in_dim, self.hidden_dim, generator=g)
        w2 = torch.randn(self.hidden_dim, self.out_dim, generator=g)
        return MLPParams(
            w1=w1.to(dev),
            b1=torch.zeros(self.hidden_dim, device=dev),
            w2=w2.to(dev),
            b2=torch.zeros(self.out_dim, device=dev),
        )

    def apply_logits(self, params: MLPParams, x: torch.Tensor) -> torch.Tensor:
        """Forward pass up to the pre-softmax logits, f32."""
        cd = self.compute_dtype
        h = torch.sigmoid(dot(x, params.w1, cd) + params.b1)
        return dot(h, params.w2, cd) + params.b2

    def apply(self, params: MLPParams, x: torch.Tensor) -> torch.Tensor:
        """Forward pass → class probabilities, f32."""
        return torch.softmax(self.apply_logits(params, x), dim=-1)
