"""Paged KV-cache primitives: block-table gather and scatter, and the
attention of an extend step, in plain PyTorch.

Counterpart of ``distributed_tensorflow_tpu/ops/paged_attention.py``:
``gather_block_view`` (:42), ``scatter_token_kv`` (:54),
``scatter_token_kv_all_layers`` (:76) and ``paged_extend_attention``
(:96). The JAX package computes these outside any Pallas kernel, so they
stay plain here.

K/V live in one pool of fixed-size blocks ``[num_blocks, bs, Hkv, Dh]``
per layer; position ``p`` of slot ``s`` lives at
``pool[table[s, p // bs], p % bs]``. A gather reads garbage for unused
table entries, which the callers' validity masks keep out of every
softmax.

Invalid writes (pad positions, slots not admitted) are dropped. The JAX
package routes them to a sentinel block one past the pool and scatters
with ``mode="drop"``; PyTorch has no such mode (an index past the pool
raises, and ``-1`` would wrap into the last block), so here the valid
rows are selected first and only they are written. A valid position past
the table's extent raises. Selecting rows costs one device sync on a
CUDA tensor. Scatters update the pool IN PLACE and return it.
"""

from __future__ import annotations

import math

import torch

from distributed_tensorflow_tpu_torch.ops.attention import NEG_INF, group_query_heads
from distributed_tensorflow_tpu_torch.ops.quantized import movable


def gather_block_view(pool_layer: torch.Tensor, block_tables: torch.Tensor):
    """One layer's per-slot contiguous view through the block tables:
    ``[NB, bs, Hkv, Dh]`` + ``[S, MB]`` → ``[S, MB*bs, Hkv, Dh]``, where
    view position ``p`` is logical position ``p`` of the slot."""
    s, mb = block_tables.shape
    view = movable(pool_layer)[block_tables.long()]  # [S, MB, bs, Hkv, Dh]
    return view.reshape(s, mb * pool_layer.shape[1], *pool_layer.shape[2:]).view(
        pool_layer.dtype)


def scatter_token_kv(pool_layer, kv, block_tables, positions, valid):
    """Write rows ``kv`` [S, L, Hkv, Dh] at logical ``positions`` [S, L]
    of one layer's pool where ``valid`` [S, L]; in place. Live slots never
    map the same writable block, so the written rows are disjoint."""
    scatter_token_kv_all_layers(pool_layer[None], kv[None], block_tables, positions, valid)
    return pool_layer


def scatter_token_kv_all_layers(pool, kvs, block_tables, positions, valid):
    """All-layer variant: ``pool`` [n, NB, bs, Hkv, Dh], ``kvs``
    [n, S, L, Hkv, Dh]; in place."""
    scatter_rows([pool], [kvs], block_tables, positions, valid)
    return pool


def scatter_rows(pools, rows_in, block_tables, positions, valid):
    """Each ``pools[i]`` [n, NB, bs, ...] takes ``rows_in[i]`` [n, S, L, ...]
    at ``positions`` [S, L] where ``valid``, through one selection of the
    valid rows (one device sync for a K/V pool and its scale pools)."""
    bs = pools[0].shape[2]
    rows, cols = valid.bool().nonzero(as_tuple=True)
    pos = positions[rows, cols].long()
    bidx = block_tables[rows, pos // bs].long()
    for pool, kvs in zip(pools, rows_in):
        movable(pool)[:, bidx, pos % bs] = movable(kvs.to(pool.dtype))[:, rows, cols]


def paged_extend_attention(q, k_new, v_new, k_view, v_view, q_positions,
                           prefix_lens, suffix_lens, window=None):
    """Attention of an EXTEND step: suffix queries over (the cached prefix
    read through the tables) ++ (the suffix's own fresh K/V), causal by
    absolute position.

    q [S, L, Hq, Dh] at ``q_positions`` [S, L]; k_new/v_new [S, L, Hkv, Dh]
    the suffix's rows; k_view/v_view [S, C, Hkv, Dh] the gathered views,
    view index j being position j. View keys need ``j < prefix_lens``
    STRICTLY (the suffix's own positions there hold garbage); fresh keys
    the causal triangle and ``< suffix_lens``. ``window=W`` adds the band
    ``key_pos > q_pos - W`` on both halves (the pool addresses absolutely,
    so the band is a mask, not a rolling layout). f32 scores and softmax;
    the output comes back in the query's dtype."""
    s, l, hq, dh = q.shape
    hkv = k_new.shape[2]
    c = k_view.shape[1]
    dev = q.device
    qg = group_query_heads(q, hkv).float()  # [S, L, Hkv, G, Dh]
    kcat = torch.cat([k_view.float(), k_new.float()], dim=1)  # [S, C+L, Hkv, Dh]
    vcat = torch.cat([v_view.float(), v_new.float()], dim=1)
    scores = torch.einsum("slhgd,skhd->shglk", qg, kcat) * (1.0 / math.sqrt(dh))
    kpos = torch.cat([torch.arange(c, device=dev)[None].expand(s, c), q_positions], dim=1)
    real = torch.cat([
        torch.arange(c, device=dev)[None, :] < prefix_lens[:, None],
        torch.arange(l, device=dev)[None, :] < suffix_lens[:, None],
    ], dim=1)  # [S, C+L]
    mask = real[:, None, :] & (kpos[:, None, :] <= q_positions[:, :, None])  # [S, L, C+L]
    if window is not None:
        mask &= kpos[:, None, :] > q_positions[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("shglk,skhd->slhgd", w, vcat)
    return out.reshape(s, l, hq, dh).to(q.dtype)
