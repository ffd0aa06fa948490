"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas_attention.py``
``flash_attention`` (:822) / ``flash_attention_with_lse`` (:883), forward
only (the backward kernels come with the training slice). The kernel,
``csrc/flash_fwd.cu``, replaces the TPU kernel ``_fwd_kernel`` (:208).

Layout [B, L, H, D] as in the JAX package; the output comes back in the
input dtype and the log-sum-exp as [B, L, Hq] f32. A CUDA tensor launches
the kernel (or raises); a CPU tensor runs the plain version. Unlike the
JAX ``_pick_block``, which refuses L=1023, any length works: the kernel
masks its ragged last tile.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops.attention import (
    attention_scores,
    repeat_kv,
)

# Below this length the model's "flash" attention uses the dense path (the
# JAX package's FLASH_MIN_LEN default); models pass flash_min_len=0 to force
# the kernel at every length.
FLASH_MIN_LEN = 1024

_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _check(q, k, v, kv_lens, window):
    if window is not None:
        raise NotImplementedError(
            "sliding-window flash attention is not ported yet (ROADMAP A3)"
        )
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes must match: {k.shape} {v.shape}")
    if (
        q.ndim != 4
        or q.shape[0] != k.shape[0]
        or q.shape[1] != k.shape[1]
        or q.shape[3] != k.shape[3]
        or q.shape[2] % k.shape[2]
    ):
        raise ValueError(
            f"q {tuple(q.shape)} incompatible with k/v {tuple(k.shape)}: "
            "batch/len/head_dim must match and query heads must be a "
            "multiple of KV heads"
        )
    if kv_lens is not None and tuple(kv_lens.shape) != (q.shape[0],):
        raise ValueError(
            f"kv_lens must be [batch]=({q.shape[0]},), got {tuple(kv_lens.shape)}"
        )


def flash_attention_plain(q, k, v, *, causal=False, kv_lens=None):
    """The plain version: the same masked softmax in f32, returning
    ``(out [B, L, Hq, D] in q's dtype, lse [B, L, Hq] f32)``."""
    kr, vr = repeat_kv(k, v, q.shape[2])
    scores = attention_scores(q, kr, causal=causal, kv_lens=kv_lens)
    lse = torch.logsumexp(scores, dim=-1)  # [B, H, Lq]
    w = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", w, vr.float())
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def _flash_cuda(q, k, v, causal, kv_lens):
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
        q.dtype == k.dtype == v.dtype
    ):
        raise ValueError(
            f"flash kernel takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, l, hq, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = None if kv_lens is None else kv_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, l, hq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes, fn.restype = _SIG, ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if lens is None else lens.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, l, hq, k.shape[2], d, int(causal), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd")
    _build.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention_with_lse(q, k, v, *, causal=False, window=None, kv_lens=None):
    """Exact attention on [B, L, H, D] without an [L, L] score matrix in
    device memory. ``kv_lens`` [B] int (each ≥ 1) masks keys at positions
    ≥ kv_lens[b]; k/v may carry fewer heads (GQA). Returns ``(out, lse)``."""
    _check(q, k, v, kv_lens, window)
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, kv_lens)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens)


def flash_attention(q, k, v, *, causal=False, window=None, kv_lens=None):
    """:func:`flash_attention_with_lse` without the log-sum-exp — the
    drop-in for :func:`ops.attention.dense_attention`."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, window=window, kv_lens=kv_lens
    )[0]
