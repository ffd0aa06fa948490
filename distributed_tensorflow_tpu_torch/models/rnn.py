"""The recurrent classifier: an LSTM over row-sequential MNIST.

Counterpart of ``distributed_tensorflow_tpu/models/rnn.py``: each
flattened ``[B, T*F]`` image (or shaped ``[B, T, F]``) is read as T rows of
F features, an LSTM cell runs over the rows, and a dense head on the last
hidden state gives f32 class probabilities.

- The four gate projections are one product a step against the stacked
  ``[in+hidden, 4, hidden]`` kernel (the JAX layout), gates in the order
  i, f, g, o. ``torch.nn.LSTM`` is not used: its gate order and weight
  layout are not this cell's.
- The products take operands cast to ``compute_dtype`` and accumulate in
  f32 (``models/mlp.dot``); cell and hidden state stay f32.
- The time loop is an eager Python loop over the T steps, where the JAX
  package traces ``lax.scan``: T small steps of launches, forward and
  backward. A graph of the loop is later work.

Init is fan-in-scaled normal with the +1 forget-gate bias, drawn from a
``torch.Generator`` on the device seeded with ``seed`` (not the JAX
PRNG's draw; the tests hand both packages the same numpy weights).

Tensor parallelism (:meth:`LSTMClassifier.partition_specs`, JAX
:148-161): the hidden units are split over the axis (the gate kernel and
biases on their hidden dim, the head on its input dim). Given the blocks
and ``tp`` (``ops/collectives.TensorParallel``), each cell step computes
its local units' gates and state and gathers the whole h for the next
step's product (``gather_from``: its backward sums every rank's part of
the gradient and keeps this rank's block); the head's partial logits are
summed over the axis before the bias.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.mlp import dot


class LSTMParams(NamedTuple):
    """Parameters. Gate order on the stacked axis: i, f, g, o."""

    w: torch.Tensor  # [in+hidden, 4, hidden] fused gate kernel
    b: torch.Tensor  # [4, hidden] gate biases (forget gate init to +1)
    head_w: torch.Tensor  # [hidden, out]
    head_b: torch.Tensor  # [out]


class LSTMClassifier:
    """LSTM cell over rows → dense head → softmax, on [B, T*F] input."""

    def __init__(
        self,
        seq_len: int = 28,
        feature_dim: int = 28,
        hidden_dim: int = 128,
        out_dim: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        self.seq_len = seq_len
        self.feature_dim = feature_dim
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim
        self.compute_dtype = compute_dtype

    # -- init --------------------------------------------------------------

    def init(self, seed: int = 1, device=None) -> LSTMParams:
        """Fan-in-scaled normal kernels, +1 forget-gate bias, zeros
        elsewhere, on ``device`` (default cuda)."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        fan_in = self.feature_dim + self.hidden_dim
        b = torch.zeros(4, self.hidden_dim, device=dev)
        b[1] = 1.0  # forget gate
        return LSTMParams(
            w=torch.randn(fan_in, 4, self.hidden_dim, generator=g, device=dev)
            * (1.0 / fan_in) ** 0.5,
            b=b,
            head_w=torch.randn(self.hidden_dim, self.out_dim, generator=g, device=dev)
            * (1.0 / self.hidden_dim) ** 0.5,
            head_b=torch.zeros(self.out_dim, device=dev),
        )

    # -- forward -----------------------------------------------------------

    def _cell(self, params: LSTMParams, carry, x_t: torch.Tensor):
        """One LSTM step: the fused-gate product and the f32 state update.
        ``carry = (h, c)``, [B, hidden] f32 (under tensor parallelism h
        whole, c and the returned h over the kernel's local units)."""
        h, c = carry
        z = torch.cat([x_t, h], dim=-1)
        fan_in, _, hid = params.w.shape
        gates = dot(z, params.w.reshape(fan_in, 4 * hid), self.compute_dtype)
        gates = gates.reshape(-1, 4, hid) + params.b
        i = torch.sigmoid(gates[:, 0])
        f = torch.sigmoid(gates[:, 1])
        g = torch.tanh(gates[:, 2])
        o = torch.sigmoid(gates[:, 3])
        c = f * c + i * g
        h = o * torch.tanh(c)
        return h, c

    def apply_logits(self, params: LSTMParams, x: torch.Tensor, tp=None) -> torch.Tensor:
        """Forward pass → pre-softmax logits, f32. Takes flattened
        ``[B, T*F]`` batches or shaped ``[B, T, F]``; runs on the
        :meth:`partition_specs` blocks over ``tp`` when given."""
        if x.ndim == 2:
            x = x.reshape(x.shape[0], self.seq_len, self.feature_dim)
        x = x.float()
        h = torch.zeros(x.shape[0], self.hidden_dim, device=x.device)
        carry = (h, torch.zeros(x.shape[0], params.w.shape[-1], device=x.device))
        for t in range(x.shape[1]):
            if t and tp is not None:
                carry = (tp.gather_from(carry[0], -1), carry[1])
            carry = self._cell(params, carry, x[:, t])
        out = dot(carry[0], params.head_w, self.compute_dtype)
        return (out if tp is None else tp.reduce_from(out)) + params.head_b

    def apply(self, params: LSTMParams, x: torch.Tensor, tp=None) -> torch.Tensor:
        """Forward pass → class probabilities, f32."""
        return torch.softmax(self.apply_logits(params, x, tp), dim=-1)

    # -- parallelism -------------------------------------------------------

    def partition_specs(self, model_axis: str = "model") -> LSTMParams:
        """Megatron's column→row split over the hidden units: the gate kernel
        and biases on their hidden dim, the head on its input dim, head_b
        replicated."""
        return LSTMParams(w=(None, None, model_axis), b=(None, model_axis),
                          head_w=(model_axis, None), head_b=(None,))
