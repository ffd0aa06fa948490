"""Quantized KV caches: the per-row symmetric int8/fp8 recipe.

Counterpart of the KV half of ``distributed_tensorflow_tpu/ops/quantized.py``:
``_EPS`` and ``_QMAX`` (:59-62), ``_amax_scale`` (:67), ``_quantize`` (:75),
``KV_DTYPES``, ``kv_storage_dtype``, ``kv_elem_bytes``, ``quantize_kv``
(:196) and ``dequantize_kv`` (:216). The quantized matmuls and weight-only
projections wait for ROADMAP A5.

A cache row (one position of one KV head, ``Dh`` values) is stored as
1-byte codes plus one f32 scale ``max(amax, eps) / qmax``. int8 rounds
half to even and clips to ±127; fp8 is ``torch.float8_e4m3fn`` (round to
nearest even; ``x / scale`` stays within ±448). The CUDA decode kernels
quantize their fresh rows with the same arithmetic.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
# Largest magnitudes the scales map amax onto: int8's 127, e4m3fn's 448.
_QMAX = {"int8": 127.0, "fp8": 448.0}
MATMUL_DTYPES = tuple(_QMAX)
# "bf16" is the identity layout: the cache stores the compute dtype, no scales.
KV_DTYPES = ("bf16",) + MATMUL_DTYPES


def _amax_scale(x, dim, qmax):
    """Symmetric scale mapping max|x| over ``dim`` onto ``qmax`` (floored
    at eps, so an all-zero row quantizes to zeros)."""
    amax = x.float().abs().amax(dim=dim, keepdim=True)
    return torch.clamp(amax, min=_EPS) / qmax


def _quantize(xs, dtype: str, qmax: float):
    """Pre-scaled ``xs = x / scale`` → stored codes: int8 rounds (half to
    even) and clips, fp8 casts."""
    if dtype == "int8":
        return torch.clamp(torch.round(xs), -qmax, qmax).to(torch.int8)
    return xs.to(torch.float8_e4m3fn)


def kv_storage_dtype(kv_dtype: str, compute_dtype):
    """The torch dtype a ``kv_dtype`` cache stores its K/V payload in."""
    if kv_dtype == "bf16":
        return compute_dtype
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown kv dtype {kv_dtype!r}; one of {KV_DTYPES}")


def kv_elem_bytes(kv_dtype: str, compute_dtype) -> int:
    """Bytes per stored K/V element (the pool's byte accounting)."""
    return torch.empty((), dtype=kv_storage_dtype(kv_dtype, compute_dtype)).element_size()


def kv_quant_dtype(payload_dtype) -> str | None:
    """The ``kv_dtype`` name of a quantized payload dtype, None otherwise."""
    return {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(payload_dtype)


def movable(t):
    """``t`` for data movement (indexing, ``where``, padding): an fp8
    tensor as its bytes (``uint8``), since not every PyTorch build
    implements those ops for float8; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize_kv(x, kv_dtype: str):
    """Rows ``[..., Dh]`` → ``(codes [..., Dh], scale [...] f32)``, one
    symmetric scale per row (amax over the last axis)."""
    qmax = _QMAX.get(kv_dtype)
    if qmax is None:
        raise ValueError(
            f"quantize_kv needs a quantized dtype, one of {MATMUL_DTYPES}; got {kv_dtype!r}"
        )
    scale = _amax_scale(x, -1, qmax)
    return _quantize(x.float() / scale, kv_dtype, qmax), scale[..., 0]


def dequantize_kv(q, scale, out_dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: ``q × scale`` in ``out_dtype``."""
    return (q.float() * scale[..., None]).to(out_dtype)


def as_stored(x, payload_dtype, compute_dtype):
    """Fresh K/V rows ``[..., Dh]`` as a cache of ``payload_dtype`` stores
    them and as a later read attends them: ``(payload, scale, attended)``.
    A 1-byte payload (int8, e4m3) gives the codes, one f32 scale a row and
    the codes dequantized to ``compute_dtype``; any other gives ``x`` in
    ``payload_dtype`` twice and no scale."""
    qd = kv_quant_dtype(payload_dtype)
    if qd is None:
        stored = x.to(payload_dtype)
        return stored, None, stored
    codes, scale = quantize_kv(x, qd)
    return codes, scale, dequantize_kv(codes, scale, compute_dtype)
