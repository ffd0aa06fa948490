"""The model protocol and shared model pieces (counterpart of
``distributed_tensorflow_tpu/models/base.py``).

A model is any object with ``init``/``apply``:

- ``init(seed, device=None) -> params``: the parameter NamedTuple, built
  deterministically from an integer seed on ``device`` (default cuda), so
  every rank computes the same initial state;
- ``apply(params, x) -> outputs``: the forward pass.

The strategies (``parallel/strategy.py``) and the ``Trainer`` depend only
on this protocol, so every family of ``models/__init__.MODEL_REGISTRY``
drops into them unchanged.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch


@runtime_checkable
class Model(Protocol):
    def init(self, seed: int, device=None) -> Any: ...

    def apply(self, params: Any, x: torch.Tensor) -> torch.Tensor: ...


def resolve_flash_min_len(value: int | None) -> int:
    """The one resolver of every model's ``flash_min_len`` (GPT and the
    transformer classifier): ``None`` → ``ops/flash_attention.FLASH_MIN_LEN``
    (the JAX package's measured crossover), else the value. Imported
    lazily, at forward time behind the ``attention_impl == "flash"`` test,
    as the JAX resolver is."""
    if value is not None:
        return value
    from distributed_tensorflow_tpu_torch.ops.flash_attention import FLASH_MIN_LEN

    return FLASH_MIN_LEN


def layernorm(x, scale, bias, eps: float = 1e-5):
    """f32 layernorm over the last axis — the JAX ``models/base.layernorm``
    arithmetic (biased variance, ``rsqrt(var + eps)``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)) * scale + bias


def rope(x, positions, base: float = 10000.0):
    """Rotary position embedding on [B, L, H, Dh] at absolute ``positions``
    [L] or [B, L] — the JAX ``models/gpt._rope`` pair rotation
    (x_i, x_{i+Dh/2}) by pos·base^(−2i/Dh), computed in f32 and cast back.
    Lives here (not in ``models/gpt.py``) because the plain decode op uses
    it too."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.float()[..., :, None] * freqs
    cos = torch.cos(ang).unsqueeze(-2)
    sin = torch.sin(ang).unsqueeze(-2)
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)
