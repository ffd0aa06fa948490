"""Sequence-parallel attention over a mesh axis: the ring and Ulysses.

Counterpart of ``distributed_tensorflow_tpu/ops/ring_attention.py``. Each
rank of the ``seq`` axis holds local blocks q, k, v [B, L/n, H, D] of an
L-token sequence; the KV blocks ride the ring (one
:meth:`parallel.mesh.Mesh.ring_permute` a hop: the JAX ``lax.ppermute``),
and the hops' partial results combine exactly:

- :func:`ring_attention` (JAX :83): each hop's block attended in plain
  PyTorch with an online softmax (running max, sum and accumulator);
- :func:`ring_flash_attention` (JAX :198): each hop runs the flash kernels
  (``ops/flash_attention.flash_attention_with_lse``: B3 forward, B4
  backward) and the hops combine by their log-sum-exp. Causal hops are the
  diagonal (causal flash), past blocks (non-causal) or future blocks
  (skipped); under a sliding window the ring runs only
  :func:`window_hops` hops, so blocks outside the band never move, and
  each past hop runs causal+window flash at the ring ``offset`` step·L/n
  (the shifted band: the kernels' offset variant);
- :func:`ulysses_attention` (JAX :471): an all-to-all trades sequence
  shards for head shards, full-sequence attention runs locally, and a
  second all-to-all trades back.

Under GQA only the KV heads ride the ring. ``kv_lens`` [B] is the
key-padding mask in global positions; each hop passes the kernel its
block-relative remainder ``clip(kv_lens − src·L/n, 0, L/n)``.

Gradients are autograd's through the collectives (the permute's backward
is the inverse permute), so every rank must run the same collectives in
the same order in the backward as well: a skipped future hop still ties
its KV block into the result with a zero weight, so the backward's
permutes run on every rank.
"""

from __future__ import annotations

import math

import torch

from distributed_tensorflow_tpu_torch.ops.attention import (  # noqa: F401 (re-exported)
    NEG_INF,
    check_window,
    dense_attention,
    group_query_heads,
    repeat_kv,
)

# Hops that ring_flash_attention ran, by kind: "diag", "full", "offset"
# (a windowed past hop at a ring offset) and "skip" (a future block).
HOPS = {"diag": 0, "full": 0, "offset": 0, "skip": 0}


def reset_hops() -> None:
    for k in HOPS:
        HOPS[k] = 0


def window_hops(window: int | None, l_loc: int, n: int) -> int:
    """Ring steps a sliding window needs (JAX ``_window_hops`` :71): the
    farthest-back key a local query sees is ceil((W − 1) / L_loc) blocks
    behind, plus the diagonal. Later hops would hold KV wholly outside
    every band and never happen."""
    if window is None:
        return n
    return min(n, -(-(window - 1) // l_loc) + 1)


def _hop_lens(kv_lens, src: int, l_loc: int):
    """Block-relative key padding of the block that started on rank
    ``src`` (its keys cover global positions [src·L_loc, (src+1)·L_loc))."""
    if kv_lens is None:
        return None
    return torch.clamp(kv_lens - src * l_loc, 0, l_loc)


def _anchor(o, kb, vb):
    """``o`` unchanged, with a zero-weight dependence on a skipped hop's
    block, so that the block's permutes run in every rank's backward."""
    return o + 0.0 * (kb.sum() + vb.sum()).float()


def ring_attention(q, k, v, mesh, axis: str = "seq", *, causal: bool = False,
                   window: int | None = None, kv_lens=None):
    """Exact attention over a sequence sharded on ``axis``: local q [B,
    L_loc, Hq, D] against every rank's k/v [B, L_loc, Hkv, D] as they come
    round the ring, with an online softmax in f32. Equal to
    ``dense_attention`` over the gathered sequence (causal, windowed,
    ``kv_lens`` in global positions). Returns the local output block in
    q's dtype."""
    check_window(causal, window)
    n, my = mesh.axis_size(axis), mesh.axis_index(axis)
    b, l_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    m = torch.full((b, h, l_loc, 1), NEG_INF, device=q.device)
    s = torch.zeros((b, h, l_loc, 1), device=q.device)
    o = torch.zeros((b, h, l_loc, d), device=q.device)
    q_pos = my * l_loc + torch.arange(l_loc, device=q.device)
    hops = window_hops(window, l_loc, n)
    kv = (k, v)
    for step in range(hops):
        kb, vb = kv
        src = (my - step) % n
        if causal and src > my:  # a future block: every score masked
            o = _anchor(o, kb, vb)
        else:
            kr, vr = repeat_kv(kb, vb, h)
            k_pos = src * l_loc + torch.arange(l_loc, device=q.device)
            mask = None
            if causal:
                diff = q_pos[:, None] - k_pos[None, :]
                mask = diff >= 0
                if window is not None:
                    mask &= diff < window
                mask = mask[None, None]
            if kv_lens is not None:
                valid = (k_pos[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
                mask = valid if mask is None else mask & valid
            scores = torch.einsum("bqhd,bkhd->bhqk", q32, kr.float()) * scale
            if mask is not None:
                scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            # A row masked so far has m_new == -1e30: exp(s - m_new) would be 1.
            m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
            corr = torch.exp(m - m_safe)
            p = torch.exp(scores - m_safe)
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            s = s * corr + p.sum(-1, keepdim=True)
            o = o * corr + torch.einsum("bhqk,bkhd->bhqd", p, vr.float())
            m = m_new
        if step < hops - 1:
            kv = mesh.ring_permute(kv, axis)
    out = o / torch.clamp(s, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _combine(o, lse, o_i, lse_i):
    """Two partial results over disjoint key sets, by their log-sum-exp:
    the weights sum to 1, and a row with no key so far (lse ~ -1e30) adds
    0."""
    new = torch.logaddexp(lse, lse_i)
    o = o * torch.exp(lse - new)[..., None] + o_i.float() * torch.exp(lse_i - new)[..., None]
    return o, new


def ring_flash_attention(q, k, v, mesh, axis: str = "seq", *, causal: bool = False,
                         window: int | None = None, kv_lens=None, fused=None):
    """:func:`ring_attention` with each hop's block attended by the flash
    kernels and the hops combined by their log-sum-exp, so no rank holds
    an [L_loc, L_loc] score matrix. Without a window a hop is the diagonal
    (causal flash), a past block (non-causal flash) or a future block
    (skipped: weight 0). With ``window=W`` the ring runs
    :func:`window_hops` hops: the diagonal hop runs causal+window flash,
    each past hop causal+window flash at ``offset = step·L_loc`` (the
    kernels' offset variant), and a block that wrapped round from the
    future is skipped. ``fused`` picks the flash backward (see
    ``flash_attention.resolve_fused``). Differentiable: the lse
    cotangent folds into the flash backward's delta."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_with_lse

    check_window(causal, window)
    n, my = mesh.axis_size(axis), mesh.axis_index(axis)
    b, l_loc, h, d = q.shape
    o = torch.zeros((b, l_loc, h, d), device=q.device)
    lse = torch.full((b, l_loc, h), NEG_INF, device=q.device)
    hops = window_hops(window, l_loc, n)
    kv = (k, v)
    for step in range(hops):
        kb, vb = kv
        src = (my - step) % n
        lens = _hop_lens(kv_lens, src, l_loc)
        if causal and src > my:
            HOPS["skip"] += 1
            o = _anchor(o, kb, vb)
        else:
            if window is not None:
                kind, kw = (("diag", {}) if step == 0
                            else ("offset", {"offset": step * l_loc}))
                kw.update(causal=True, window=window)
            elif causal and src == my:
                kind, kw = "diag", {"causal": True}
            else:
                kind, kw = "full", {"causal": False}
            HOPS[kind] += 1
            o_i, lse_i = flash_attention_with_lse(q, kb, vb, kv_lens=lens, fused=fused, **kw)
            o, lse = _combine(o, lse, o_i, lse_i)
        if step < hops - 1:
            kv = mesh.ring_permute(kv, axis)
    return o.to(q.dtype)


def all_to_all_seq_to_heads(x, mesh, axis: str = "seq"):
    """[B, L/n, H, D] sharded by sequence → [B, L, H/n, D] sharded by head
    (one all-to-all; JAX :446)."""
    n = mesh.axis_size(axis)
    b, l_loc, h, d = x.shape
    x = mesh.all_to_all(x.reshape(b, l_loc, n, h // n, d), axis, split_axis=2, concat_axis=1)
    return x.reshape(b, n * l_loc, h // n, d)


def all_to_all_heads_to_seq(x, mesh, axis: str = "seq"):
    """The inverse of :func:`all_to_all_seq_to_heads` (JAX :458): the
    received axis is the head group, the major part of the head index."""
    n = mesh.axis_size(axis)
    b, l, h_loc, d = x.shape
    x = mesh.all_to_all(x.reshape(b, n, l // n, h_loc, d), axis, split_axis=1, concat_axis=3)
    return x.permute(0, 1, 3, 2, 4).reshape(b, l // n, n * h_loc, d)


def ulysses_attention(q, k, v, mesh, axis: str = "seq", *, causal: bool = False,
                      window: int | None = None):
    """Sequence-parallel attention by all-to-all (Ulysses): reshard to
    head-parallel, dense attention over the whole sequence locally (the
    window as its band mask), reshard back. The axis size must divide both
    head counts (local q head j then reads local KV head j // g, as
    ``repeat_kv``)."""
    n = mesh.axis_size(axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) and kv heads ({k.shape[2]}) "
                         f"divisible by the axis size {n}")
    q2, k2, v2 = (all_to_all_seq_to_heads(t, mesh, axis) for t in (q, k, v))
    out = dense_attention(q2, k2, v2, causal=causal, window=window)
    return all_to_all_heads_to_seq(out, mesh, axis)
