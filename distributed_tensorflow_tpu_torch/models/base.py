"""Shared model pieces (counterpart of ``distributed_tensorflow_tpu/models/base.py``).

The serving slice needs ``layernorm`` and ``rope``; the model protocol
comes with the classifiers (ROADMAP A6b).
"""

from __future__ import annotations

import torch


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
