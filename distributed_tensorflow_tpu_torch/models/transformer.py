"""The sequence classifier: a single-block transformer over MNIST rows.

Counterpart of ``distributed_tensorflow_tpu/models/transformer.py``
(``apply``, the single-device forward). Each image is a sequence of
``seq_len`` rows of ``token_dim`` pixels:

    row embed + learned positions → pre-LN attention block with residual
      → pre-LN MLP block (gelu) with residual → mean-pool → linear head

Every product takes operands cast to ``compute_dtype`` and accumulates in
f32 (``models/mlp.dot``; the JAX ``_dot`` with ``preferred_element_type``),
so q, k and v are f32 whatever the compute dtype; layernorm, softmax and
gelu (the tanh approximation, ``jax.nn.gelu``'s default) run in f32.

Attention is ``ops/attention.dense_attention``, or with
``attention_impl="flash"`` the flash kernels (``ops/flash_attention``:
B3 forward, B4 backward) wherever the sequence is at least
``resolve_flash_min_len(flash_min_len)`` long (default 1024, so the
28-row images take the kernels only with ``flash_min_len=0``). At the
default widths (``model_dim=64``, 4 heads) the head dim is 16, and the
kernels run their f32 (split-TF32) instantiation.

Init is the JAX package's (fan-in-scaled normal dense weights, 0.02-scaled
positions, unit layernorm scales, zero biases and head), drawn from a
``torch.Generator`` on the device seeded with ``seed``: deterministic, not
the JAX PRNG's draw.

``apply_sequence_parallel`` (JAX :181) runs the forward on one rank's
shard of the rows over a mesh axis: the ring, ring-flash or Ulysses
attention of ``ops/ring_attention.py`` (not causal), and the mean-pool as
a mean over the axis (``Mesh.pmean``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.base import layernorm, resolve_flash_min_len
from distributed_tensorflow_tpu_torch.models.mlp import dot
from distributed_tensorflow_tpu_torch.ops.attention import dense_attention


class TransformerParams(NamedTuple):
    embed: torch.Tensor  # [token_dim, model_dim]
    pos: torch.Tensor  # [seq_len, model_dim]
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor  # [model_dim, model_dim]
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w_up: torch.Tensor  # [model_dim, 4*model_dim]
    b_up: torch.Tensor
    w_down: torch.Tensor  # [4*model_dim, model_dim]
    b_down: torch.Tensor
    w_head: torch.Tensor  # [model_dim, classes]
    b_head: torch.Tensor


class TransformerClassifier:
    """seq_len tokens of token_dim features → num_classes probabilities."""

    def __init__(
        self,
        seq_len: int = 28,
        token_dim: int = 28,
        model_dim: int = 64,
        num_heads: int = 4,
        num_classes: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "xla",
        flash_min_len: int | None = None,
    ):
        if model_dim % num_heads:
            raise ValueError(f"model_dim {model_dim} must be divisible by num_heads {num_heads}")
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}; xla|flash")
        self.seq_len = seq_len
        self.token_dim = token_dim
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.head_dim = model_dim // num_heads
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        # None → the one measured crossover (models/base.resolve_flash_min_len);
        # 0 takes the kernels at every length.
        self.flash_min_len = flash_min_len

    def init(self, seed: int = 1, device=None) -> TransformerParams:
        """The JAX package's init (see the module docstring) on ``device``
        (default cuda)."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        d = self.model_dim

        def dense(shape):
            return torch.randn(shape, generator=g, device=dev) / shape[0] ** 0.5

        def const(n, value):
            return torch.full((n,), value, dtype=torch.float32, device=dev)

        return TransformerParams(
            embed=dense((self.token_dim, d)),
            pos=0.02 * torch.randn(self.seq_len, d, generator=g, device=dev),
            ln1_scale=const(d, 1.0),
            ln1_bias=const(d, 0.0),
            wq=dense((d, d)),
            wk=dense((d, d)),
            wv=dense((d, d)),
            wo=dense((d, d)),
            ln2_scale=const(d, 1.0),
            ln2_bias=const(d, 0.0),
            w_up=dense((d, 4 * d)),
            b_up=const(4 * d, 0.0),
            w_down=dense((4 * d, d)),
            b_down=const(d, 0.0),
            w_head=torch.zeros(d, self.num_classes, device=dev),
            b_head=const(self.num_classes, 0.0),
        )

    # -- forward pieces ----------------------------------------------------

    def _dot(self, x, w):
        return dot(x, w, self.compute_dtype)

    def _embed(self, p: TransformerParams, x):
        tokens = x.reshape(x.shape[0], self.seq_len, self.token_dim)
        return self._dot(tokens, p.embed) + p.pos

    def _qkv(self, p: TransformerParams, h):
        b, l, _ = h.shape
        hn = layernorm(h, p.ln1_scale, p.ln1_bias)
        shape = (b, l, self.num_heads, self.head_dim)
        return tuple(self._dot(hn, w).reshape(shape) for w in (p.wq, p.wk, p.wv))

    def _post_attention(self, p: TransformerParams, h, attn_out):
        b, l, _, _ = attn_out.shape
        h = h + self._dot(attn_out.reshape(b, l, self.model_dim), p.wo)
        hn = layernorm(h, p.ln2_scale, p.ln2_bias)
        mlp = self._dot(F.gelu(self._dot(hn, p.w_up) + p.b_up, approximate="tanh"), p.w_down)
        return h + mlp + p.b_down

    def _head_probs(self, p: TransformerParams, h):
        logits = self._dot(h.mean(dim=1), p.w_head) + p.b_head
        return torch.softmax(logits.float(), dim=-1)

    def _attend(self, q, k, v):
        if self.attention_impl == "flash" and q.shape[1] >= resolve_flash_min_len(
                self.flash_min_len):
            from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

            return flash_attention(q, k, v)
        return dense_attention(q, k, v)

    # -- public forward ----------------------------------------------------

    def apply(self, params: TransformerParams, x: torch.Tensor) -> torch.Tensor:
        """Single-device forward: x [B, seq_len*token_dim] → probabilities."""
        h = self._embed(params, x)
        h = self._post_attention(params, h, self._attend(*self._qkv(params, h)))
        return self._head_probs(params, h)

    def apply_sequence_parallel(self, params: TransformerParams, x: torch.Tensor, mesh,
                                axis: str = "seq", *, attention: str | None = None):
        """The forward on this rank's shard x [B, (seq_len/n)·token_dim] of
        the rows split over ``axis`` of ``mesh`` (params replicated): the
        probabilities, equal to :meth:`apply` on the whole image.
        ``attention`` is ``"ring"``, ``"ring_flash"`` (the flash kernels a
        hop) or ``"ulysses"`` (heads divisible by the axis size); the
        default follows ``attention_impl``. A collective."""
        from distributed_tensorflow_tpu_torch.ops.ring_attention import (
            ring_attention,
            ring_flash_attention,
            ulysses_attention,
        )

        if attention is None:
            attention = "ring_flash" if self.attention_impl == "flash" else "ring"
        if attention not in ("ring", "ring_flash", "ulysses"):
            raise ValueError(f"unknown attention {attention!r}; ring|ring_flash|ulysses")
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        l_loc = self.seq_len // n
        tokens = x.reshape(x.shape[0], l_loc, self.token_dim)
        h = self._dot(tokens, params.embed) + params.pos[my * l_loc:(my + 1) * l_loc]
        q, k, v = self._qkv(params, h)
        if attention == "ring":
            attn = ring_attention(q, k, v, mesh, axis)
        elif attention == "ring_flash":
            attn = ring_flash_attention(q, k, v, mesh, axis)
        else:
            if self.num_heads % n:
                raise ValueError(f"ulysses needs heads ({self.num_heads}) divisible by "
                                 f"the {axis!r} axis size ({n})")
            attn = ulysses_attention(q, k, v, mesh, axis)
        h = self._post_attention(params, h, attn)
        logits = self._dot(mesh.pmean(h.mean(dim=1), axis), params.w_head) + params.b_head
        return torch.softmax(logits.float(), dim=-1)
