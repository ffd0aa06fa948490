"""Dense attention: the plain reference for prefill.

Counterpart of ``distributed_tensorflow_tpu/ops/ring_attention.py``
``dense_attention`` (:391), ``group_query_heads`` (:361) and ``repeat_kv``
(:376). Layout [B, L, H, D] as there; the math is f32 throughout and the
output comes back in the query's dtype.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def group_query_heads(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """[..., Hq, D] → [..., Hkv, G, D]: query head h belongs to KV head
    ``h // (Hq/Hkv)`` — the one q-head→KV-head mapping of the port."""
    *lead, hq, d = q.shape
    if hq % num_kv_heads:
        raise ValueError(
            f"query heads {hq} must be a multiple of KV heads {num_kv_heads}"
        )
    return q.reshape(*lead, num_kv_heads, hq // num_kv_heads, d)


def repeat_kv(k, v, num_q_heads: int):
    """Repeat k/v heads [B, L, Hkv, D] up to ``num_q_heads`` (GQA)."""
    hkv = k.shape[2]
    if hkv == num_q_heads:
        return k, v
    if num_q_heads % hkv:
        raise ValueError(
            f"query heads {num_q_heads} must be a multiple of KV heads {hkv}"
        )
    g = num_q_heads // hkv
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def attention_scores(q, k, *, causal=False, kv_lens=None):
    """Masked f32 scores [B, Hq, Lq, Lk] of [B, L, H, D] inputs (k already
    repeated to Hq): scale 1/√D, masked entries at -1e30 — shared by
    :func:`dense_attention` and the plain flash version."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    lq, lk = scores.shape[-2], scores.shape[-1]
    if causal:
        mask = (
            torch.arange(lq, device=q.device)[:, None]
            >= torch.arange(lk, device=q.device)[None, :]
        )
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    if kv_lens is not None:
        valid = torch.arange(lk, device=q.device)[None, :] < kv_lens[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    return scores


def dense_attention(q, k, v, *, causal=False, kv_lens=None):
    """Dense attention on [B, L, H, D]: ``causal`` mask, ``kv_lens`` [B] int
    right-padding mask (each ≥ 1), GQA by repeating k/v to the query heads.
    (The sliding window waits for ROADMAP A3.)"""
    k, v = repeat_kv(k, v, q.shape[2])
    scores = attention_scores(q, k, causal=causal, kv_lens=kv_lens)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)
