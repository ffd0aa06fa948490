"""Low-precision (int8 / fp8) matmuls and quantized KV caches.

Counterpart of ``distributed_tensorflow_tpu/ops/quantized.py``: ``_EPS`` and
``_QMAX`` (:59-62), ``_amax_scale`` (:67), ``_quantize`` (:75), the training
product ``quantized_dot`` (:86-135), the per-tensor ``quantize_tensor`` /
``dequantize_tensor`` (:150-170), ``KV_DTYPES``, ``kv_storage_dtype``,
``kv_elem_bytes``, ``quantize_kv`` (:196) and ``dequantize_kv`` (:216), and
the weight-only decode weights ``QuantizedLinear`` / ``quantize_linear_columns``
/ ``wo_dot`` (:227-266).

``quantized_dot`` quantizes each activation row and each weight column
symmetrically (dynamic scales), multiplies the codes with an exact
accumulation (int8: int32; fp8: f32) and applies the row and column scales
after it; its backward is the straight-through estimator, the exact f32
products of the unquantized operands. The JAX package leaves the product
to XLA (no Pallas kernel), so here the codes' product is PyTorch's: on the
card ``torch._int_mm`` (int8) or ``torch._scaled_mm`` with unit scales
(e4m3), the operands zero-padded to the shapes those calls take (padding
adds zero terms and padded rows are sliced off, so it is exact); on the
CPU the plain product (``code_product_plain``: int64 for int8, never f32,
which loses exactness past 2^24; f32 for e4m3). Neither call is a kernel
of this repository: the JAX package has no Pallas kernel here either.

A cache row (one position of one KV head, ``Dh`` values) is stored as
1-byte codes plus one f32 scale ``max(amax, eps) / qmax``. int8 rounds
half to even and clips to ±127; fp8 is ``torch.float8_e4m3fn`` (round to
nearest even; ``x / scale`` stays within ±448). The CUDA decode kernels
quantize their fresh rows with the same arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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


# -- the training product: quantized_dot ------------------------------------


def _pad_to(t, rows, cols):
    """``t`` [m, k] zero-padded at the end to [rows, cols]."""
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _up(n: int, a: int) -> int:
    return -(-n // a) * a


def code_product_plain(xq, wq):
    """The exact product of codes ``xq`` [m, k] and ``wq`` [k, n] as f32,
    computed plainly: int8 codes in int64 on the CPU and in f64 on the card
    (every partial sum an integer below 2^53, so exact in any order); e4m3
    codes in f32 (each product exact, the sums rounded in f32)."""
    if xq.dtype == torch.int8:
        if xq.is_cuda:
            return (xq.double() @ wq.double()).float()
        return (xq.long() @ wq.long()).float()
    return xq.float() @ wq.float()


def code_product(xq, wq):
    """:func:`code_product_plain`'s result through PyTorch's low-precision
    products on the card: ``torch._int_mm`` (int8: more than 16 rows, k and
    n multiples of 8) or ``torch._scaled_mm`` with unit scales (e4m3:
    multiples of 16), each with a column-major second operand, the operands
    zero-padded to those shapes and the result cut back. On the CPU the
    plain product."""
    if not xq.is_cuda:
        return code_product_plain(xq, wq)
    m, k = xq.shape
    n = wq.shape[1]
    if xq.dtype == torch.int8:
        mp, kp, np_ = max(_up(m, 8), 24), _up(k, 8), _up(n, 8)
        # cuBLASLt's int8 product takes the second operand column-major.
        acc = torch._int_mm(_pad_to(xq, mp, kp), _pad_to(wq, kp, np_).t().contiguous().t())
        return acc[:m, :n].float()
    mp, kp, np_ = _up(m, 16), _up(k, 16), _up(n, 16)
    a = _pad_to(movable(xq), mp, kp).view(torch.float8_e4m3fn)
    b = _pad_to(movable(wq), kp, np_).view(torch.float8_e4m3fn).t().contiguous().t()
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    out = torch._scaled_mm(a, b, scale_a=one, scale_b=one, out_dtype=torch.float32)
    return out[:m, :n]


def _qdot_impl(dtype: str, x, w, product=code_product):
    """The JAX ``_qdot_impl``: ``x`` [..., K] and ``w`` [K, N] quantized
    with one scale an activation row and one a weight column, the codes'
    product (``product``) accumulated exactly, the scales applied after:
    f32 [..., N]."""
    if dtype not in _QMAX:
        raise ValueError(f"unknown matmul dtype {dtype!r}; one of {MATMUL_DTYPES}")
    qmax = _QMAX[dtype]
    sx = _amax_scale(x, -1, qmax)  # [..., 1]
    sw = _amax_scale(w, 0, qmax)  # [1, N]
    xq = _quantize(x.float() / sx, dtype, qmax)
    wq = _quantize(w.float() / sw, dtype, qmax)
    acc = product(xq.reshape(-1, x.shape[-1]), wq).reshape(*x.shape[:-1], w.shape[1])
    return acc * sx * sw


def quantized_dot_plain(dtype: str, x, w):
    """:func:`quantized_dot`'s forward with the codes' product computed
    plainly on any device (:func:`code_product_plain`): its yardstick on
    the card."""
    return _qdot_impl(dtype, x, w, code_product_plain)


class _QuantizedDot(torch.autograd.Function):
    """Forward: :func:`_qdot_impl`. Backward: the straight-through
    estimator (JAX ``_qdot_bwd``), the exact f32 transposes of the
    unquantized operands."""

    @staticmethod
    def forward(ctx, dtype, x, w):
        ctx.save_for_backward(x, w)
        return _qdot_impl(dtype, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        dx = (gf @ w.float().T).to(x.dtype)
        dw = (x.float().reshape(-1, x.shape[-1]).T @ gf.reshape(-1, gf.shape[-1])).to(w.dtype)
        return None, dx, dw


def quantized_dot(dtype: str, x, w):
    """``x [..., K] @ w [K, N]`` with the contraction in ``dtype`` ("int8"
    or "fp8"), f32 out, dynamic symmetric scales a row of ``x`` and a
    column of ``w``; differentiable through the straight-through
    estimator (the gradients are the exact f32 products of the unquantized
    operands)."""
    return _QuantizedDot.apply(dtype, x, w)


# -- per-tensor quantization (the DiLoCo outer delta's) --------------------


def quantize_tensor(x, dtype: str):
    """``x`` → ``(codes, scale)`` with ONE f32 scale for the whole tensor
    (amax over every element, floored at eps)."""
    if dtype not in _QMAX:
        raise ValueError(f"unknown tensor dtype {dtype!r}; one of {MATMUL_DTYPES}")
    qmax = _QMAX[dtype]
    scale = torch.clamp(x.float().abs().amax(), min=_EPS) / qmax
    return _quantize(x.float() / scale, dtype, qmax), scale


def dequantize_tensor(q, scale, out_dtype=torch.float32):
    """Inverse of :func:`quantize_tensor`: ``q × scale`` in ``out_dtype``."""
    return (q.float() * scale).to(out_dtype)


# -- weight-only decode matmuls --------------------------------------------


class QuantizedLinear(NamedTuple):
    """A pre-quantized projection weight: ``qw [..., K, N]`` int8/e4m3 codes
    with one f32 ``scale [..., N]`` an output column (dequantized value
    ``qw · scale``). Made once by :func:`quantize_linear_columns` /
    ``GPTLM.decode_weights``; ``GPTLM._dot`` takes it through
    :func:`wo_dot`. Leading axes (the layer stack) ride along."""

    qw: torch.Tensor
    scale: torch.Tensor


def quantize_linear_columns(w, dtype: str) -> QuantizedLinear:
    """``w [..., K, N]`` → :class:`QuantizedLinear` with one symmetric scale
    an output column (amax over K)."""
    if dtype not in _QMAX:
        raise ValueError(f"unknown weight dtype {dtype!r}; one of {MATMUL_DTYPES}")
    qmax = _QMAX[dtype]
    scale = _amax_scale(w, -2, qmax)  # [..., 1, N]
    return QuantizedLinear(qw=_quantize(w.float() / scale, dtype, qmax), scale=scale[..., 0, :])


def wo_dot(x, qw, scale, compute_dtype=torch.bfloat16):
    """Weight-only quantized product: ``x [..., K]`` and the codes ``qw
    [K, N]`` both in ``compute_dtype`` (codes convert exactly, |q| <= 448),
    f32 accumulation, then the column scales: f32 [..., N]. Forward only."""
    acc = x.to(compute_dtype).float() @ qw.to(compute_dtype).float()
    return acc * scale


def index_leaf(t, i):
    """Layer ``i`` of a layer-stacked leaf: a tensor's row, or a
    ``QuantizedLinear``'s codes and scales each at ``i``."""
    if isinstance(t, QuantizedLinear):
        return QuantizedLinear(t.qw[i], t.scale[i])
    return t[i]
