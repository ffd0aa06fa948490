"""Fused single-token GPT decode: the CUDA kernels and their plain versions.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas_decode.py`` for the
bf16 slab cache:

- :func:`decode_block_slab` (JAX :524) — one layer's step per slot; the
  fresh K/V rows return to the caller, which commits them with
  :func:`commit_slot_rows`. Kernel ``decode_block_kernel`` in
  ``csrc/fused_decode.cu`` replaces ``_fused_decode_kernel`` (:181).
- :func:`decode_token_slab` (JAX :1007) — every layer in one launch, the
  commit done in the kernel for active rows only. Kernel
  ``decode_token_kernel`` replaces ``_mega_decode_kernel`` (:618).

The plain versions follow the JAX package's XLA engine
(``models/gpt.py`` ``_decode_block_slots`` and ``_commit_slot_rows``):
layernorm and softmax in f32, products of compute-dtype operands with f32
accumulation, the fresh rows round-tripped through the cache dtype, the
normalized softmax weights cast to the cache dtype before they weight the
values. Attention reads the PRE-write cache (positions < length) and
takes the fresh row at position ``length`` from the projection, which is
the same sum the XLA engine forms after its commit.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. Caches are updated IN PLACE (the JAX functions return new
arrays; here the returned tensors are the ones passed in).

``weights`` is a dict of the block fields of ``GPTBlockParams`` — one
layer's tensors for :func:`decode_block_slab`, layer-stacked ones (leading
[n_layers]) for :func:`decode_token_slab`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.models.base import layernorm, rope
from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops.attention import NEG_INF, group_query_heads

WEIGHT_NAMES = (
    "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
    "ln2_scale", "ln2_bias", "w_up", "b_up", "w_down", "b_down",
)
# The projections, stored in the compute dtype; the rest stay f32.
PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def dot(x, w, compute_dtype):
    """``GPTLM._dot_full``: operands cast to the compute dtype, product
    accumulated in f32 (the operands are upcast so the output is not
    rounded back to bf16)."""
    if compute_dtype == torch.float32:
        return x.float() @ w.float()
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def commit_slot_rows(ck, cv, kq, vq, lengths, active):
    """Write the fresh rows ``kq``/``vq`` [S, Hkv, Dh] into one layer's
    cache ``ck``/``cv`` [S, C, Hkv, Dh] at position ``lengths[s]`` for the
    active rows; inactive rows write their old value back (a no-op), as
    the JAX ``_commit_slot_rows`` does. In place."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    c = ck.shape[1]
    pos = lengths.long().clamp(0, c - 1)
    # A row already at capacity is never written (the kernel's rule too).
    act = (active.bool() & (lengths < c))[:, None, None]
    ck[rows, pos] = torch.where(act, kq.to(ck.dtype), ck[rows, pos])
    cv[rows, pos] = torch.where(act, vq.to(cv.dtype), cv[rows, pos])


def _block_plain(h, w, ck, cv, lengths, num_heads, rope_on, cd):
    """One layer's step (plain): returns (h_out [S, d] f32, k_fresh,
    v_fresh [S, Hkv, Dh] in the cache dtype)."""
    s, d = h.shape
    c, hkv, dh = ck.shape[1], ck.shape[2], ck.shape[3]
    hn = layernorm(h, w["ln1_scale"], w["ln1_bias"])
    q = dot(hn, w["wq"], cd).reshape(s, 1, num_heads, dh)
    k = dot(hn, w["wk"], cd).reshape(s, 1, hkv, dh)
    v = dot(hn, w["wv"], cd).reshape(s, 1, hkv, dh)
    if rope_on:
        pos = lengths[:, None]
        q, k = rope(q, pos), rope(k, pos)
    kq, vq = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    qg = group_query_heads(q[:, 0], hkv)  # [S, Hkv, g, Dh]
    sq = math.sqrt(dh)
    sc = torch.einsum("shgd,skhd->shgk", qg, ck.float()) / sq
    valid = torch.arange(c, device=h.device)[None, :] < lengths[:, None]
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    sf = (qg * kq.float()[:, :, None, :]).sum(-1, keepdim=True) / sq
    p = torch.softmax(torch.cat([sc, sf], dim=-1), dim=-1).to(cv.dtype).float()
    attn = torch.einsum("shgk,skhd->shgd", p[..., :c], cv.float())
    attn = attn + p[..., c:] * vq.float()[:, :, None, :]
    h = h + dot(attn.reshape(s, num_heads * dh), w["wo"], cd)
    hn2 = layernorm(h, w["ln2_scale"], w["ln2_bias"])
    up = dot(hn2, w["w_up"], cd) + w["b_up"]
    ffn = dot(F.gelu(up, approximate="tanh"), w["w_down"], cd) + w["b_down"]
    return h + ffn, kq, vq


def decode_block_slab_plain(h, weights, ck, cv, lengths, *, num_heads,
                            rope=False, compute_dtype=torch.bfloat16):
    """Plain version of :func:`decode_block_slab`."""
    return _block_plain(
        h.float(), weights, ck, cv, lengths, num_heads, rope, compute_dtype
    )


def decode_token_slab_plain(h, weights, ck, cv, lengths, active, *, num_heads,
                            rope=False, compute_dtype=torch.bfloat16):
    """Plain version of :func:`decode_token_slab`: the per-layer step and
    commit, layer by layer."""
    h = h.float()
    for i in range(ck.shape[0]):
        wl = {nm: weights[nm][i] for nm in WEIGHT_NAMES}
        h, kq, vq = _block_plain(
            h, wl, ck[i], cv[i], lengths, num_heads, rope, compute_dtype
        )
        commit_slot_rows(ck[i], cv[i], kq, vq, lengths, active)
    return h, ck, cv


# -- the CUDA kernels --------------------------------------------------------

_COMMON = [ctypes.c_void_p] * 14  # h_in, h_out, 12 weights


def _kernel_args(h, weights, ck, cv, num_heads, rope_on, compute_dtype):
    """Validate and lay out the kernels' inputs; returns (h, ordered weight
    tensors, dims). Raises for anything outside the kernels' envelope."""
    if rope_on:
        raise NotImplementedError(
            "rope on the CUDA decode kernels is not ported yet (ROADMAP A3)"
        )
    if compute_dtype != torch.bfloat16 or ck.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA decode kernels take a bf16 model with a bf16 slab cache; "
            f"got compute {compute_dtype}, cache {ck.dtype} (int8/fp8 KV: "
            "ROADMAP A3)"
        )
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("the KV cache must be contiguous")
    s, d = h.shape
    c, hkv, dh = ck.shape[-3], ck.shape[-2], ck.shape[-1]
    f = weights["w_up"].shape[-1]
    dims = (s, d, num_heads, hkv, dh, f, c)
    lib = _build.load("fused_decode")
    lib.decode_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.decode_smem_bytes.restype = ctypes.c_longlong
    if lib.decode_smem_bytes(*dims) <= 0:
        raise ValueError(
            f"decode kernels do not take (S, d, Hq, Hkv, Dh, F, C)={dims}: "
            "they need head_dim 64 or 128, at most 8 query heads per KV "
            "head, widths divisible by 8, and the cache's score row in "
            "227 KB of shared memory"
        )
    ws = []
    for nm in WEIGHT_NAMES:
        t = weights[nm]
        dt = torch.bfloat16 if nm in PROJ_NAMES else torch.float32
        ws.append(t.to(device=h.device, dtype=dt).contiguous())
    return h.float().contiguous(), ws, dims, lib


def _ordered_ptrs(ws):
    """Weight pointers in the C interface's order."""
    by = dict(zip(WEIGHT_NAMES, ws))
    order = ("wq", "wk", "wv", "wo", "ln1_scale", "ln1_bias", "ln2_scale",
             "ln2_bias", "w_up", "b_up", "w_down", "b_down")
    return [by[nm].data_ptr() for nm in order]


def decode_block_slab(h, weights, ck, cv, lengths, *, num_heads, rope=False,
                      compute_dtype=torch.bfloat16):
    """One GPT block's single-token step over one layer's slab cache.

    ``h`` [S, d] f32 residual rows, ``weights`` one layer's dict,
    ``ck``/``cv`` [S, C, Hkv, Dh] (PRE-write, not modified), ``lengths``
    [S] int write positions. Returns ``(h_out [S, d] f32, k_fresh,
    v_fresh [S, Hkv, Dh] cache dtype)``."""
    if not h.is_cuda:
        if h.device.type != "cpu":
            raise ValueError(f"decode runs on cuda or cpu, got {h.device}")
        return decode_block_slab_plain(
            h, weights, ck, cv, lengths, num_heads=num_heads, rope=rope,
            compute_dtype=compute_dtype,
        )
    h, ws, dims, lib = _kernel_args(
        h, weights, ck, cv, num_heads, rope, compute_dtype
    )
    s, _, _, hkv, dh, _, _ = dims
    out = torch.empty_like(h)
    kf = torch.empty((s, hkv, dh), dtype=ck.dtype, device=h.device)
    vf = torch.empty_like(kf)
    lens = lengths.to(torch.int32).contiguous()
    fn = lib.decode_block_slab
    fn.argtypes = _COMMON + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        h.data_ptr(), out.data_ptr(), *_ordered_ptrs(ws),
        ck.data_ptr(), cv.data_ptr(), lens.data_ptr(),
        kf.data_ptr(), vf.data_ptr(), *dims,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "decode_block_slab")
    _build.LAUNCHES["decode_block_slab"] += 1
    return out, kf, vf


def decode_token_slab(h, weights, ck, cv, lengths, active, *, num_heads,
                      rope=False, compute_dtype=torch.bfloat16):
    """The whole model's single-token step over the slab cache, one launch.

    ``h`` [S, d] f32 embedded rows, ``weights`` layer-stacked,
    ``ck``/``cv`` [n_layers, S, C, Hkv, Dh], ``lengths`` [S] int,
    ``active`` [S] bool. Returns ``(h_out [S, d] f32, ck, cv)`` with the
    fresh rows committed in place at the active rows' ``lengths``."""
    if not h.is_cuda:
        if h.device.type != "cpu":
            raise ValueError(f"decode runs on cuda or cpu, got {h.device}")
        return decode_token_slab_plain(
            h, weights, ck, cv, lengths, active, num_heads=num_heads,
            rope=rope, compute_dtype=compute_dtype,
        )
    h, ws, dims, lib = _kernel_args(
        h, weights, ck, cv, num_heads, rope, compute_dtype
    )
    out = torch.empty_like(h)
    lens = lengths.to(torch.int32).contiguous()
    act = active.to(torch.int32).contiguous()
    fn = lib.decode_token_slab
    fn.argtypes = _COMMON + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        h.data_ptr(), out.data_ptr(), *_ordered_ptrs(ws),
        ck.data_ptr(), cv.data_ptr(), lens.data_ptr(), act.data_ptr(),
        ck.shape[0], *dims,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "decode_token_slab")
    _build.LAUNCHES["decode_token_slab"] += 1
    return out, ck, cv
