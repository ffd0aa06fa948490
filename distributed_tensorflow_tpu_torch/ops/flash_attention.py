"""Flash attention: the CUDA kernels and their plain versions, forward and
backward.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas_attention.py``
``flash_attention`` (:822) / ``flash_attention_with_lse`` (:883) and their
custom VJP (:667-880), with the causal mask, the sliding window
(``window=W``: query i keeps key j iff ``i - W < j <= i``; each kernel
visits only the tiles of the band, as the JAX banded index maps
``_banded_k_index`` / ``_banded_q_index`` do), the ring offset
(``offset=F``, with ``causal``: query i sits at position i + F, so it keeps
key j iff ``j <= i + F`` and, with a window, ``j > i + F - W``; the JAX
``_causal_mask`` :113 and ``_block_needed`` :128, which ring-flash
attention's windowed past hops run), ``kv_lens`` and GQA. The
forward kernel, ``csrc/flash_fwd.cu``, replaces the TPU kernel ``_fwd_kernel`` (:208); the backward kernels of
``csrc/flash_bwd.cu`` replace ``_fused_bwd_kernel`` (:440), ``_dq_kernel``
(:327) and ``_dkv_kernel`` (:381).

Layout [B, L, H, D] as in the JAX package; the output comes back in the
input dtype and the log-sum-exp as [B, L, Hq] f32. The kernels are built
for the head dims ``HEAD_DIMS`` and take the scores' scale as an argument
(the JAX kernels' ``scale``, 1/√D); any other multiple of 8 up to 128 runs
on the next built one (:func:`kernel_head_dim`): q, k, v (and dO) are
zero-padded along D, the scale is the true D's, and the outputs are sliced
back. Zero columns add exact zeros to every product, so that is the same
function. Every kernel multiplies
on the tensor cores: on f32 inputs each product is split-TF32 (three TF32
MMAs, ``csrc/flash_mma.cuh``) and stays within f32 tolerance; on bf16
inputs one TF32 pass is exact. A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version. Unlike the
JAX ``_pick_block``, which refuses L=1023, any length works: the kernels
mask their ragged last tile.

Gradients go through :func:`flash_attention_op`
(``torch.ops.dtf.FlashAttention``), a ``torch.library`` operator used on
both devices: its forward is the forward kernel (or the plain forward),
and its backward forms ``delta = rowsum(dO·O) − dlse`` in f32 and then
runs the fused backward kernel or the dq + dk/dv pair (chosen by
:func:`resolve_fused`, a copy of the JAX ``_resolve_fused``: a banded
window, ``4 W <= L``, takes the pair), or on the CPU
:func:`flash_bwd_plain`. Under ``torch.no_grad()``, or when no input needs
a gradient, the forward runs alone and keeps no residuals. Being one
operator, the forward is what a selective checkpoint can save
(:func:`selective_policy`, the counterpart of the JAX ``save_names`` /
``_flash_rebuild`` composition, :783-822): the recompute then skips it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops.attention import (
    NEG_INF,
    attention_scores,
    check_window,
    repeat_kv,
)

# Below this length the model's "flash" attention uses the dense path (the
# JAX package's FLASH_MIN_LEN default); models pass flash_min_len=0 to force
# the kernel at every length.
FLASH_MIN_LEN = 1024

# flash_fwd(q, k, v, kv_lens, out, lse, B, L, Hq, Hkv, D, causal, window,
#           offset, is_bf16, scale, stream); window 0 = none.
_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
# flash_bwd(mode, q, k, v, dout, lse, delta, kv_lens, dq, dk, dv, dqp,
#           B, L, Hq, Hkv, D, causal, window, offset, is_bf16, scale, stream)
_BWD_SIG = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
_BWD_MODES = {"flash_bwd_fused": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
# The kernels' key tile: the fused backward's dq partials take ceil(L/BLOCK_K)
# copies of dq in f32.
BLOCK_K = 64
# The head dims the kernels are built for (the plain versions take any).
HEAD_DIMS = (8, 16, 32, 64, 128)
# Auto-fusion cap on those partials (the JAX package's _FUSED_DQ_CAP_BYTES):
# past it fused=None takes the dq + dk/dv pair.
FUSED_DQ_CAP_BYTES = 1 << 30


def _check(q, k, v, kv_lens, causal, window, offset=0):
    check_window(causal, window, offset)
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


def flash_attention_plain(q, k, v, *, causal=False, window=None, kv_lens=None, scale=None,
                          offset=0):
    """The plain version: the same masked softmax in f32, returning
    ``(out [B, L, Hq, D] in q's dtype, lse [B, L, Hq] f32)``. A row that
    sees no key (``window`` with ``kv_lens``: a padded row past
    ``kv_lens + W - 1``; an ``offset`` past the window; a ring hop's
    ``kv_lens`` of 0) gives 0 and lse -1e30, as the kernels and the JAX
    kernel's empty-row guard do (dense attention averages the values
    there instead). ``scale``: the scores' factor (default 1/√D)."""
    kr, vr = repeat_kv(k, v, q.shape[2])
    scores = attention_scores(q, kr, causal=causal, window=window, kv_lens=kv_lens,
                              scale=scale, offset=offset)
    lse = torch.logsumexp(scores, dim=-1)  # [B, H, Lq]
    w = torch.exp(scores - lse[..., None])
    if window is not None or offset or kv_lens is not None:
        w = torch.where(scores.amax(-1, keepdim=True) > 0.5 * NEG_INF, w, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vr.float())
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def kernel_head_dim(d: int) -> int:
    """The built head dim (``HEAD_DIMS``) that head dim ``d`` runs on:
    ``d`` itself, or the next one up for another multiple of 8 up to 128
    (24 on 32; 40, 48, 56 on 64; 72 to 120 on 128). Raises for the rest."""
    if d % 8 or not 8 <= d <= HEAD_DIMS[-1]:
        raise ValueError(f"flash kernels take a head_dim that is a multiple of 8 from 8 to "
                         f"{HEAD_DIMS[-1]}, got {d}")
    return next(k for k in HEAD_DIMS if k >= d)


def pad_head_dim(t, dp: int):
    """``t`` [..., D] zero-padded along D to ``dp`` (``t`` itself at D = dp)."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _unpad(t, d: int):
    """The first ``d`` columns of a padded output, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_kernel_inputs(*ts):
    """Dtypes and head dim; returns the built head dim the call runs on."""
    q = ts[0]
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != q.dtype for t in ts
    ):
        raise ValueError(
            "flash kernels take f32 or bf16 q/k/v (and dout) of one dtype, got "
            + "/".join(str(t.dtype) for t in ts)
        )
    return kernel_head_dim(q.shape[-1])


def _dense16(t):
    """``t`` contiguous and 16-byte aligned: the kernels copy rows into
    shared memory 16 bytes at a time (every head dim's row is a multiple of
    16 bytes: at D=8, 16 in bf16 and 32 in f32)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _window_arg(window):
    """The kernels' window argument: 0 for none."""
    return 0 if window is None else int(window)


def _flash_cuda(q, k, v, causal, kv_lens, window=None, offset=0):
    dp = _check_kernel_inputs(q, k, v)
    b, l, hq, d = q.shape
    q, k, v = (_dense16(pad_head_dim(t, dp)) for t in (q, k, v))
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
        b, l, hq, k.shape[2], dp, int(causal), _window_arg(window), int(offset),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd")
    _build.LAUNCHES["flash_fwd"] += 1
    if offset:
        _build.LAUNCHES["flash_fwd[offset]"] += 1
    return _unpad(out, d), lse


def flash_bwd_plain(q, k, v, o, lse, do, delta, kv_lens, causal, window=None, scale=None,
                    offset=0):
    """The plain backward, from the JAX kernels' formulas: ``(dq, dk, dv)``
    in the inputs' dtypes, dk/dv [B, L, Hkv, D] summed over each KV head's
    group of query heads. ``o`` is unused (``delta`` carries it) and kept
    for the kernels' signature. p is masked explicitly: a fully masked
    row's lse would otherwise turn masked entries into 1 (the comment at
    pallas_attention.py:350-353). p and ds are cast to the operand dtype
    before their products, as the JAX kernels' ``astype`` (:368, :421,
    :426); products and sums are f32. ``scale``: the scores' factor
    (default 1/√D); ``offset`` as :func:`flash_attention_plain` takes it."""
    del o
    b, l, hq, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kr, vr = repeat_kv(k, v, hq)
    qf, kf, vf, dof = q.float(), kr.float(), vr.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = torch.ones(l, l, dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid, diagonal=offset)
    if window is not None:
        valid = torch.triu(valid, diagonal=offset + 1 - window)
    valid = valid[None, None]
    if kv_lens is not None:
        kvalid = torch.arange(l, device=q.device)[None, :] < kv_lens[:, None]
        valid = valid & kvalid[:, None, None, :]
    lse_t = lse.transpose(1, 2)[..., None]  # [B, H, L, 1]
    p = torch.where(valid, torch.exp(torch.where(valid, s, NEG_INF) - lse_t), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.transpose(1, 2)[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    g = hq // hkv
    dk = dk.reshape(b, l, hkv, g, d).sum(3)
    dv = dv.reshape(b, l, hkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def use_banding(window, l: int) -> bool:
    """The JAX ``_use_banding`` (:153): a window is banded when
    ``4 W <= L``."""
    return window is not None and 4 * window <= l


def resolve_fused(fused, bh: int, l: int, d: int, window=None) -> bool:
    """``fused=None`` → auto: the fused kernel unless (a) the call is in
    the banded-window regime (:func:`use_banding`), where most of the
    fused kernel's dq-partial planes would be zeros that are still
    written and summed, or (b) its f32 dq-partial buffer,
    ``ceil(l / BLOCK_K) · bh · l · d · 4`` bytes, would exceed
    :data:`FUSED_DQ_CAP_BYTES` (the JAX ``_resolve_fused``, :763, with the
    port's own key tile). An explicit bool wins."""
    if fused is not None:
        return bool(fused)
    if use_banding(window, l):
        return False
    return -(-l // BLOCK_K) * bh * l * d * 4 <= FUSED_DQ_CAP_BYTES


def _bwd_launch(name, q, k, v, do, lse, delta, kv_lens, causal, window, outs, head_dim,
                dqp=None, offset=0):
    """One backward launch on inputs padded to a built head dim; the scale
    is ``head_dim``'s, the caller's D."""
    lib = _build.load("flash_bwd")
    fn = lib.flash_bwd
    fn.argtypes, fn.restype = _BWD_SIG, ctypes.c_int
    b, l, hq, d = q.shape

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    dq, dk, dv = outs
    err = fn(
        _BWD_MODES[name], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), ptr(kv_lens), ptr(dq), ptr(dk), ptr(dv), ptr(dqp),
        b, l, hq, k.shape[2], d, int(causal), _window_arg(window), int(offset),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(head_dim),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    if offset:
        _build.LAUNCHES[f"{name}[offset]"] += 1


def _bwd_inputs(q, k, v, do, lse, delta, kv_lens):
    """The backward's inputs as the kernels take them: q, k, v, dO padded
    to the built head dim, contiguous and aligned; lse, delta f32; kv_lens
    int32."""
    dp = _check_kernel_inputs(q, k, v, do)
    lens = None if kv_lens is None else kv_lens.to(torch.int32).contiguous()
    return (*(_dense16(pad_head_dim(t, dp)) for t in (q, k, v, do)),
            lse.float().contiguous(), delta.float().contiguous(), lens)


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal=False, window=None, kv_lens=None,
                    offset=0):
    """B4a on the card: ``(dq, dk, dv)`` in one pass over the KV tiles, dq
    from f32 partials summed by a second kernel in a fixed order."""
    d = q.shape[-1]
    q, k, v, do, lse, delta, lens = _bwd_inputs(q, k, v, do, lse, delta, kv_lens)
    b, l, hq, dp = q.shape
    dqp = torch.empty(-(-l // BLOCK_K) * b * l * hq * dp, dtype=torch.float32, device=q.device)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    _bwd_launch("flash_bwd_fused", q, k, v, do, lse, delta, lens, causal, window, outs, d, dqp,
                offset)
    return tuple(_unpad(t, d) for t in outs)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=False, window=None, kv_lens=None,
                 offset=0):
    """B4b on the card: dq, one CTA per (batch, query head, q-tile), on the
    tensor cores."""
    d = q.shape[-1]
    q, k, v, do, lse, delta, lens = _bwd_inputs(q, k, v, do, lse, delta, kv_lens)
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, lens, causal, window,
                (dq, None, None), d, offset=offset)
    return _unpad(dq, d)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=False, window=None, kv_lens=None,
                  offset=0):
    """B4c on the card: ``(dk, dv)``, one CTA per (batch, KV head, k-tile),
    summed over the group's query heads."""
    d = q.shape[-1]
    q, k, v, do, lse, delta, lens = _bwd_inputs(q, k, v, do, lse, delta, kv_lens)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, lens, causal, window,
                (None, dk, dv), d, offset=offset)
    return _unpad(dk, d), _unpad(dv, d)


def flash_bwd(q, k, v, o, lse, do, dlse, kv_lens, causal, window, fused, offset=0):
    """``(dq, dk, dv)`` from the forward's residuals and the cotangents
    ``do`` and ``dlse`` (None counts as zeros): ``delta = rowsum(do·o) −
    dlse`` in f32, as the JAX code forms it in XLA (:722), then the kernels
    on the card or :func:`flash_bwd_plain` on the CPU."""
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    if q.is_cuda:
        b, l, hq, d = q.shape
        kw = dict(causal=causal, window=window, kv_lens=kv_lens, offset=offset)
        if resolve_fused(fused, b * hq, l, d, window):
            return flash_bwd_fused(q, k, v, do, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    return flash_bwd_plain(q, k, v, o, lse, do, delta, kv_lens, causal, window, offset=offset)


def _flash_forward(q, k, v, causal, window, kv_lens, offset=0):
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, kv_lens, window, offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window, kv_lens=kv_lens,
                                 offset=offset)


@torch.library.custom_op("dtf::FlashAttention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: Optional[torch.Tensor],
    causal: bool, window: int, fused: Optional[bool], offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, k, v, kv_lens) → (out, lse)``, both differentiable: the JAX
    ``_flash`` custom VJP as an operator that autograd and a selective
    checkpoint see whole (``window`` 0 = none; ``fused`` picks the
    backward; ``offset`` the ring offset). Its backward is the operator
    :func:`flash_attention_bwd_op` on the saved ``(q, k, v, out, lse)``;
    ``kv_lens`` gets no gradient."""
    return _flash_forward(q, k, v, causal, window or None, kv_lens, offset)


@flash_attention_op.register_fake
def _flash_op_fake(q, k, v, kv_lens, causal, window, fused, offset=0):
    # Shapes only: a trace on fake tensors (utils/summary.graph_def_from_fn)
    # sees the operator as one node and launches nothing.
    b, l, hq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, l, hq), dtype=torch.float32)


@torch.library.custom_op("dtf::FlashAttentionBackward", mutates_args=())
def flash_attention_bwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, dlse: Optional[torch.Tensor], kv_lens: Optional[torch.Tensor],
    causal: bool, window: int, fused: Optional[bool], offset: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_op` (:func:`flash_bwd`: the
    backward kernels on the card), an operator of its own so that a trace
    on fake tensors keeps it one node."""
    kw = {"offset": offset} if offset else {}
    return flash_bwd(q, k, v, out, lse, dout, dlse, kv_lens, causal, window or None, fused, **kw)


@flash_attention_bwd_op.register_fake
def _flash_bwd_op_fake(q, k, v, out, lse, dout, dlse, kv_lens, causal, window, fused, offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_op_setup(ctx, inputs, output):
    q, k, v, kv_lens, causal, window, fused, offset = inputs
    ctx.save_for_backward(q, k, v, *output, kv_lens)
    ctx.causal, ctx.window, ctx.fused, ctx.offset = causal, window, fused, offset


def _flash_op_backward(ctx, dout, dlse):
    q, k, v, out, lse, kv_lens = ctx.saved_tensors
    if dout is None:
        dout = torch.zeros_like(out)
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, dout, dlse, kv_lens, ctx.causal,
                                        ctx.window, ctx.fused, ctx.offset)
    return dq, dk, dv, None, None, None, None, None


flash_attention_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)

# The operator a selective checkpoint saves (models/gpt.py remat="selective"):
# its out and lse are kept from the forward, so the recompute skips the
# forward kernel and the backward kernels run from the saved residuals (the
# JAX save_names=REMAT_SAVE_NAMES with _flash_rebuild).
REMAT_SAVE_OPS = (torch.ops.dtf.FlashAttention.default,)


def selective_policy(ctx, op, *args, **kwargs):
    """The selective-remat policy of ``torch.utils.checkpoint``: save the
    flash operator's outputs, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in REMAT_SAVE_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def flash_attention_with_lse(q, k, v, *, causal=False, window=None, kv_lens=None, fused=None,
                             offset=0):
    """Exact attention on [B, L, H, D] without an [L, L] score matrix in
    device memory. ``window=W`` (needs ``causal``, W ≥ 1) keeps each
    query's last W keys, self included. ``kv_lens`` [B] int masks keys at
    positions ≥ kv_lens[b] (a row left with no key gives 0 and lse -1e30);
    k/v may carry fewer heads (GQA). ``offset=F`` (needs ``causal``, F ≥ 0)
    puts every query F positions ahead of the keys: the ring composition's
    past hops (``ops/ring_attention.ring_flash_attention``). Returns
    ``(out, lse)``, both differentiable. ``fused`` picks the backward: None
    (auto, see :func:`resolve_fused`), True (one pass) or False (dq + dk/dv
    kernels)."""
    _check(q, k, v, kv_lens, causal, window, offset)
    offset = int(offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_op(q, k, v, kv_lens, causal, _window_arg(window), fused, offset)
    return _flash_forward(q, k, v, causal, window, kv_lens, offset)


def flash_attention(q, k, v, *, causal=False, window=None, kv_lens=None, fused=None, offset=0):
    """:func:`flash_attention_with_lse` without the log-sum-exp — the
    drop-in for :func:`ops.attention.dense_attention`."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, window=window, kv_lens=kv_lens, fused=fused, offset=offset
    )[0]
