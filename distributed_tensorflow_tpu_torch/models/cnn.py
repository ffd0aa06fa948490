"""The convolutional classifier: a LeNet-style MNIST ConvNet.

Counterpart of ``distributed_tensorflow_tpu/models/cnn.py``::

    conv(k×k, c1) → relu → maxpool 2×2 → conv(k×k, c2) → relu → maxpool 2×2
      → dense(hidden) → relu → dense(out) → softmax

It takes the same flattened ``[B, H*W*C]`` batches as the MLP (or shaped
``[B, H, W, C]``) and returns f32 class probabilities, so it drops into
the Trainer and the strategies unchanged.

Layouts are the JAX package's: conv kernels HWIO, dense kernels
``[in, out]``, activations NHWC at the model's edges (the flatten before
``fc1`` is in H, W, C order). ``conv2d`` wants NCHW activations and OIHW
weights, so the convolutions permute at use.

Rounding follows the JAX model. Each conv takes operands cast to
``compute_dtype`` and returns that dtype, rounded once a window, before the
upcast to f32: the JAX conv keeps its operands' dtype so that its backward
(a conv between the cotangent and an operand) has matching dtypes, and a
bf16 ``conv2d`` here does the same forward and backward. cuDNN's TF32 is
off in both passes (:class:`_Conv2d`), so an f32 model's convolutions are
f32. The dense products take compute-dtype operands and accumulate in f32
(``models/mlp.dot``). Padding is XLA's SAME at stride 1: k - 1 rows and
columns in all, the odd one on the high side for an even kernel.

Init is He-normal (stddev sqrt(2 / fan_in)) with zero biases, drawn from
a ``torch.Generator`` on the device seeded with ``seed``: deterministic,
but not the JAX PRNG's draw (the tests hand both packages the same numpy
weights). Pooling and products are PyTorch's (the JAX package leaves
them to XLA); no kernel of this repository runs here.

Tensor parallelism (:meth:`CNN.partition_specs`, JAX :155-177): two
column→row pairs, conv1 split on its output channels and conv2 on its
input channels, fc1 on its output features and fc2 on its input features.
Given the blocks and ``tp`` (``ops/collectives.TensorParallel``), relu and
pooling run on the local channels, each row member's partial sums are
summed over the axis (Megatron's g) before its bias, and the flattened
features enter fc1 through Megatron's f.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.mlp import dot


class CNNParams(NamedTuple):
    """Parameters. Conv kernels are HWIO, dense kernels [in, out]."""

    conv1_w: torch.Tensor  # [k, k, in_channels, c1]
    conv1_b: torch.Tensor  # [c1]
    conv2_w: torch.Tensor  # [k, k, c1, c2]
    conv2_b: torch.Tensor  # [c2]
    fc1_w: torch.Tensor  # [(H/4)*(W/4)*c2, hidden]
    fc1_b: torch.Tensor  # [hidden]
    fc2_w: torch.Tensor  # [hidden, out]
    fc2_b: torch.Tensor  # [out]


@contextlib.contextmanager
def _exact_cudnn():
    """cuDNN's TF32 off for the block, the caller's setting restored."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2d(torch.autograd.Function):
    """Unpadded, stride-1 ``conv2d`` of NCHW ``x`` and OIHW ``w`` (one
    dtype) whose forward and backward both run with cuDNN's TF32 off: the
    flag is read when each pass runs, and the backward runs outside any
    block the forward was called in."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _exact_cudnn():
            return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _exact_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1), (0, 0), (1, 1), False, (0, 0), 1,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return gx, gw


def same_pad(k: int) -> tuple[int, int]:
    """XLA's SAME padding at stride 1 for a kernel of ``k``: (low, high),
    the odd row on the high side."""
    return (k - 1) // 2, k // 2


class CNN:
    """conv→relu→pool ×2 → dense→relu → dense → softmax, on [B, H*W] input."""

    def __init__(
        self,
        image_size: int = 28,
        in_channels: int = 1,
        channels: Sequence[int] = (32, 64),
        kernel: int = 5,
        hidden_dim: int = 256,
        out_dim: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        if image_size % 4 != 0:
            raise ValueError(f"image_size {image_size} must be divisible by 4 (two 2x2 pools)")
        if len(channels) != 2:
            raise ValueError(f"channels must be (c1, c2), got {tuple(channels)}")
        self.image_size = image_size
        self.in_channels = in_channels
        self.c1, self.c2 = channels
        self.kernel = kernel
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim
        self.compute_dtype = compute_dtype
        self.flat_dim = (image_size // 4) * (image_size // 4) * self.c2

    # -- init --------------------------------------------------------------

    def init(self, seed: int = 1, device=None) -> CNNParams:
        """He-normal weights, zero biases, on ``device`` (default cuda)."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        k = self.kernel

        def he(shape, fan_in):
            return torch.randn(shape, generator=g, device=dev) * (2.0 / fan_in) ** 0.5

        def zeros(n):
            return torch.zeros(n, device=dev)

        return CNNParams(
            conv1_w=he((k, k, self.in_channels, self.c1), k * k * self.in_channels),
            conv1_b=zeros(self.c1),
            conv2_w=he((k, k, self.c1, self.c2), k * k * self.c1),
            conv2_b=zeros(self.c2),
            fc1_w=he((self.flat_dim, self.hidden_dim), self.flat_dim),
            fc1_b=zeros(self.hidden_dim),
            fc2_w=he((self.hidden_dim, self.out_dim), self.hidden_dim),
            fc2_b=zeros(self.out_dim),
        )

    # -- forward -----------------------------------------------------------

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """SAME conv of NCHW ``x`` by the HWIO kernel ``w`` in
        ``compute_dtype``, the result upcast to f32."""
        cd = self.compute_dtype
        lo, hi = same_pad(self.kernel)
        x = F.pad(x.to(cd), (lo, hi, lo, hi))
        return _Conv2d.apply(x, w.to(cd).permute(3, 2, 0, 1)).float()

    @staticmethod
    def _max_pool(x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, 2, 2)

    def apply_logits(self, params: CNNParams, x: torch.Tensor, tp=None) -> torch.Tensor:
        """Forward pass → pre-softmax logits, f32. Takes flattened
        ``[B, H*W*C]`` batches or shaped ``[B, H, W, C]``; runs on the
        :meth:`partition_specs` blocks over ``tp`` when given."""
        cd = self.compute_dtype
        s = self.image_size
        g = (lambda t: t) if tp is None else tp.reduce_from  # noqa: E731
        if x.ndim == 2:
            x = x.reshape(x.shape[0], s, s, self.in_channels)
        h = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        h = torch.relu(self._conv(h, params.conv1_w) + params.conv1_b[:, None, None])
        h = self._max_pool(h)
        h = torch.relu(g(self._conv(h, params.conv2_w)) + params.conv2_b[:, None, None])
        h = self._max_pool(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], self.flat_dim)  # the NHWC flatten
        if tp is not None:
            h = tp.copy_to(h)
        h = torch.relu(dot(h, params.fc1_w, cd) + params.fc1_b)
        return g(dot(h, params.fc2_w, cd)) + params.fc2_b

    def apply(self, params: CNNParams, x: torch.Tensor, tp=None) -> torch.Tensor:
        """Forward pass → class probabilities, f32."""
        return torch.softmax(self.apply_logits(params, x, tp), dim=-1)

    # -- parallelism -------------------------------------------------------

    def partition_specs(self, model_axis: str = "model") -> CNNParams:
        """Megatron's two column→row pairs over ``model_axis``: conv1 on its
        output channels / conv2 on its input channels, fc1 on its output
        features / fc2 on its input features; conv2_b and fc2_b (added after
        the sums) replicated."""
        return CNNParams(
            conv1_w=(None, None, None, model_axis),
            conv1_b=(model_axis,),
            conv2_w=(None, None, model_axis, None),
            conv2_b=(None,),
            fc1_w=(None, model_axis),
            fc1_b=(model_axis,),
            fc2_w=(model_axis, None),
            fc2_b=(None,),
        )
