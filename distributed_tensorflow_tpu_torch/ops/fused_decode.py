"""Fused GPT decode and speculation verify: the CUDA kernels and their plain
versions.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas_decode.py``, slab and
paged, with RoPE, bf16 or f32 compute (the JAX kernels' ``compute_dtype=``)
and caches of the compute dtype or of int8 or fp8 (e4m3) codes, at head dims
4, 8, 16, 32, 64 and 128:

- :func:`decode_block_slab` (JAX :524) and :func:`decode_block_paged`
  (:566) — one layer's step per slot; the fresh K/V rows return to the
  caller, which commits them (:func:`commit_slot_rows`,
  :func:`commit_paged_rows`). Kernel ``coop_step_kernel<Rows, false,
  true>`` in ``csrc/fused_decode.cu`` (the cooperative body below, one
  layer, the fresh rows written out) replaces ``_fused_decode_kernel``
  (:181).
- :func:`decode_token_slab` (JAX :1007) and :func:`decode_token_paged`
  (:1046) — every layer in one launch, the commit done in the kernel for
  active rows only. Kernel ``coop_step_kernel<Rows, false, false>`` replaces
  ``_mega_decode_kernel`` (:618).
- :func:`verify_tokens_paged` (JAX :1305) — the speculation verify: L
  draft rows per slot through every layer in one launch over the paged
  pool, committing the real rows in the kernel. Kernel
  ``coop_step_kernel<PagedRows, true, false>`` replaces ``_verify_kernel``
  (:1083).

A windowed model (``window=W``) keeps its slab as a ROLLING buffer of C
slots, position p at slot ``p mod C`` (the JAX package's ``rolling`` slab,
C = ``min(W, max_len)``), and its pool absolutely; both attend only the
band of positions ``> length - W`` (on the slab also ``> length - C``:
the write slot holds position ``length - C``), and the verify's row li
only cache positions ``> prefix + li - W`` and fresh rows ``lj > li - W``.

Each is one cooperative launch over the whole card (:func:`coop_plan` lays
it out: the grid, the tiles of each product, the weight ring's chunks, the
scratch between phases and the shared memory); each weight element is read
once a launch. The kernel is built for each compute dtype (one library
each, ``LIBRARIES``) and cache type (``KV_TYPES``).

A cache of 1-byte codes (``int8`` or ``float8_e4m3fn``) carries one f32
scale a row (a position of a KV head) in ``k_scale``/``v_scale`` (the
cache's shape without ``Dh``), as in the JAX package: the fresh rows are
quantized on write (``ops/quantized.quantize_kv``) and every read
dequantizes to the compute dtype, the fresh rows included (they are
attended as they are stored). A cache of the compute dtype (the "bf16"
layout) has no scales (None).

The plain decode versions follow the JAX package's XLA engine
(``models/gpt.py`` ``_decode_block_slots`` / ``_decode_block_paged`` and
the commits): layernorm and softmax in f32, products of compute-dtype
operands with f32 accumulation, the fresh rows round-tripped through the
cache dtype, the normalized softmax weights cast to the cache dtype before
they weight the values. Attention reads the PRE-write cache (positions <
length) and takes the fresh row at position ``length`` from the
projection, which is the same sum the XLA engine forms after its commit.
The plain verify follows the JAX verify kernel: ``extend_paged``'s math
with the fresh rows rounded through the cache dtype before attention and
commit, f32 softmax weights, and 0 for a row with no valid key.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. Caches and pools are updated IN PLACE (the JAX functions return
new arrays; here the returned tensors are the ones passed in). Paged
position ``p`` of slot ``s`` lives at ``pool[table[s, p // bs], p % bs]``;
the tables must hold valid block ids for every position a launch reads or
writes (the kernels do not check them).

``weights`` is a dict of the block fields of ``GPTBlockParams`` — one
layer's tensors for the per-layer functions, layer-stacked ones (leading
[n_layers]) for the others.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.models.base import layernorm, rope
from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops.attention import NEG_INF, group_query_heads
from distributed_tensorflow_tpu_torch.ops.paged_attention import (
    gather_block_view,
    paged_extend_attention,
    scatter_rows,
)
from distributed_tensorflow_tpu_torch.ops.quantized import (
    as_stored,
    dequantize_kv,
    index_leaf,
    movable,
)

WEIGHT_NAMES = (
    "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
    "ln2_scale", "ln2_bias", "w_up", "b_up", "w_down", "b_down",
)
# The projections, stored in the compute dtype; the rest stay f32.
PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_up", "w_down")
# The head dims the kernels take (the attention task's lanes a key row:
# Dh / 8 in bf16 compute, Dh / 4 in f32, and one at Dh = 4, where a bf16
# lane takes a half slot).
HEAD_DIMS = (4, 8, 16, 32, 64, 128)
_rope = rope  # the wrappers' keyword `rope` shadows the function inside them


def dot(x, w, compute_dtype):
    """``GPTLM._dot_full``: operands cast to the compute dtype, product
    accumulated in f32 (the operands are upcast so the output is not
    rounded back to bf16)."""
    if compute_dtype == torch.float32:
        return x.float() @ w.float()
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def commit_slot_rows(ck, cv, kq, vq, lengths, active, ks=None, vs=None, kqs=None,
                     vqs=None, window=None):
    """Write the fresh rows ``kq``/``vq`` [S, Hkv, Dh] into one layer's
    cache ``ck``/``cv`` [S, C, Hkv, Dh] at position ``lengths[s]`` for the
    active rows, and their scales ``kqs``/``vqs`` [S, Hkv] into ``ks``/``vs``
    [S, C, Hkv] (1-byte caches); inactive rows write their old value back
    (a no-op), as the JAX ``_commit_slot_rows`` does. With ``window`` the
    slab rolls: the row goes to slot ``lengths[s] % C``. In place."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    c = ck.shape[1]
    if window is not None:
        pos = lengths.long() % c
        act = active.bool()
    else:
        pos = lengths.long().clamp(0, c - 1)
        # A row already at capacity is never written (the kernel's rule too).
        act = active.bool() & (lengths < c)
    for dst, new in ((ck, kq), (cv, vq), (ks, kqs), (vs, vqs)):
        if dst is not None:
            m = act.reshape((-1,) + (1,) * (new.dim() - 1))
            d = movable(dst)
            d[rows, pos] = torch.where(m, movable(new.to(dst.dtype)), d[rows, pos])


def commit_paged_rows(pool_k, pool_v, kq, vq, tables, lengths, active, ks=None, vs=None,
                      kqs=None, vqs=None):
    """The JAX ``_commit_paged_rows``: write the fresh rows [S, Hkv, Dh]
    (and, 1-byte pools, their scales [S, Hkv] into the scale pools
    ``ks``/``vs`` [NB, bs, Hkv]) into one layer's pool [NB, bs, Hkv, Dh] at
    position ``lengths[s]`` through the tables, for active rows below the
    tables' extent (the kernel's rule); the others are dropped. In place."""
    extent = tables.shape[1] * pool_k.shape[1]
    valid = (active.bool() & (lengths < extent))[:, None]
    pairs = [(d, n[None, :, None]) for d, n in ((pool_k, kq), (pool_v, vq), (ks, kqs),
                                                 (vs, vqs)) if d is not None]
    scatter_rows([d[None] for d, _ in pairs], [n for _, n in pairs], tables,
                 lengths[:, None], valid)


def _ffn_plain(h, w, cd):
    """LN2, the tanh-GELU FFN and its residual."""
    hn2 = layernorm(h, w["ln2_scale"], w["ln2_bias"])
    up = dot(hn2, w["w_up"], cd) + w["b_up"]
    return h + dot(F.gelu(up, approximate="tanh"), w["w_down"], cd) + w["b_down"]


def _fresh_rows(k, v, cache_dtype, cd):
    """The fresh rows as stored and as attended (:func:`as_stored`):
    ``(kq, vq, kqs, vqs, k_att, v_att)``, ``k_att``/``v_att`` f32."""
    (kq, kqs, ka), (vq, vqs, va) = as_stored(k, cache_dtype, cd), as_stored(v, cache_dtype, cd)
    return kq, vq, kqs, vqs, ka.float(), va.float()


def _cache_view(c, scale, cd):
    """A cache view as attended, f32: a cache of the compute dtype as
    stored, 1-byte codes dequantized to the compute dtype ``cd``."""
    return c.float() if scale is None else dequantize_kv(c, scale, cd).float()


def slab_valid(lengths, c, window=None):
    """[S, C] bool: the slab slots a step at ``lengths`` attends, read
    pre-write. Without a window the positions below the length; with one,
    the rolling buffer's identity (JAX ``pallas_decode.py`` :296-303): slot
    i holds position ``length - ((length % C - i) mod C)``, valid when
    that is ≥ 0 and above ``length - W``, and i is not the write slot (its
    position, ``length - C``, has left the window)."""
    idx = torch.arange(c, device=lengths.device)[None, :]
    ln = lengths.long()[:, None]
    if window is None:
        return idx < ln
    slot = ln % c
    pos = ln - torch.remainder(slot - idx, c)
    # The band test is a no-op at the model's C = min(W, max_len) <= W.
    return (pos >= 0) & (pos > ln - window) & (idx != slot)


def paged_valid(lengths, c, window=None):
    """[S, C] bool: the absolute view positions a step at ``lengths``
    attends, read pre-write: below the length and, with a window, above
    ``length - W``."""
    idx = torch.arange(c, device=lengths.device)[None, :]
    ln = lengths.long()[:, None]
    valid = idx < ln
    if window is not None:
        valid &= idx > ln - window
    return valid


def _block_plain(h, w, ck, cv, lengths, valid, num_heads, rope_on, cd, ks=None, vs=None,
                 dot_fn=None, ffn_fn=None):
    """One layer's step (plain) over the per-slot view ``ck``/``cv``
    [S, C, Hkv, Dh] (scales ``ks``/``vs`` [S, C, Hkv] for 1-byte codes)
    whose positions ``valid`` [S, C] the step attends: returns (h_out
    [S, d] f32, k_fresh, v_fresh [S, Hkv, Dh] as stored, their scales
    [S, Hkv] or None). ``dot_fn(x, w)`` and ``ffn_fn(h, w)`` (LN2, the FFN
    and its residual) replace the dense compute-dtype products and FFN
    (a MoE or quantized model's own, ``GPTLM._plain_fns``)."""
    s, d = h.shape
    c, hkv, dh = ck.shape[1], ck.shape[2], ck.shape[3]
    dot_fn = dot_fn or (lambda x, wt: dot(x, wt, cd))
    hn = layernorm(h, w["ln1_scale"], w["ln1_bias"])
    q = dot_fn(hn, w["wq"]).reshape(s, 1, num_heads, dh)
    k = dot_fn(hn, w["wk"]).reshape(s, 1, hkv, dh)
    v = dot_fn(hn, w["wv"]).reshape(s, 1, hkv, dh)
    if rope_on:
        pos = lengths[:, None]
        q, k = rope(q, pos), rope(k, pos)
    kq, vq, kqs, vqs, kf, vf = _fresh_rows(k[:, 0], v[:, 0], ck.dtype, cd)
    qg = group_query_heads(q[:, 0], hkv)  # [S, Hkv, g, Dh]
    sq = math.sqrt(dh)
    sc = torch.einsum("shgd,skhd->shgk", qg, _cache_view(ck, ks, cd)) / sq
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    sf = (qg * kf[:, :, None, :]).sum(-1, keepdim=True) / sq
    # The weights round to the dtype the values are attended in.
    pdt = cv.dtype if vs is None else cd
    p = torch.softmax(torch.cat([sc, sf], dim=-1), dim=-1).to(pdt).float()
    attn = torch.einsum("shgk,skhd->shgd", p[..., :c], _cache_view(cv, vs, cd))
    attn = attn + p[..., c:] * vf[:, :, None, :]
    h = h + dot_fn(attn.reshape(s, num_heads * dh), w["wo"])
    h = ffn_fn(h, w) if ffn_fn else _ffn_plain(h, w, cd)
    return h, kq, vq, kqs, vqs


def _layer(weights, i):
    return {nm: index_leaf(t, i) for nm, t in weights.items()}


def _at(scale, i):
    return None if scale is None else scale[i]


def decode_block_slab_plain(h, weights, ck, cv, lengths, *, num_heads, rope=False,
                            compute_dtype=torch.bfloat16, k_scale=None, v_scale=None,
                            window=None):
    """Plain version of :func:`decode_block_slab`."""
    return _block_plain(h.float(), weights, ck, cv, lengths,
                        slab_valid(lengths, ck.shape[1], window), num_heads, rope,
                        compute_dtype, k_scale, v_scale)


def decode_token_slab_plain(h, weights, ck, cv, lengths, active, *, num_heads, rope=False,
                            compute_dtype=torch.bfloat16, k_scale=None, v_scale=None,
                            window=None, dot_fn=None, ffn_fn=None):
    """Plain version of :func:`decode_token_slab`: the per-layer step and
    commit, layer by layer (``dot_fn`` / ``ffn_fn``: :func:`_block_plain`'s,
    for the plain decode of models the kernel does not take)."""
    h = h.float()
    valid = slab_valid(lengths, ck.shape[2], window)
    for i in range(ck.shape[0]):
        ks, vs = _at(k_scale, i), _at(v_scale, i)
        h, kq, vq, kqs, vqs = _block_plain(h, _layer(weights, i), ck[i], cv[i], lengths, valid,
                                           num_heads, rope, compute_dtype, ks, vs, dot_fn,
                                           ffn_fn)
        commit_slot_rows(ck[i], cv[i], kq, vq, lengths, active, ks, vs, kqs, vqs, window)
    return h, ck, cv


def decode_block_paged_plain(h, weights, pool_k, pool_v, tables, lengths, *, num_heads,
                             rope=False, compute_dtype=torch.bfloat16, k_scale=None,
                             v_scale=None, window=None, dot_fn=None, ffn_fn=None):
    """Plain version of :func:`decode_block_paged`: the PRE-write view
    gathered through the tables, then the slab step."""
    ck = gather_block_view(pool_k, tables)
    cv = gather_block_view(pool_v, tables)
    ks = None if k_scale is None else gather_block_view(k_scale, tables)
    vs = None if v_scale is None else gather_block_view(v_scale, tables)
    return _block_plain(h.float(), weights, ck, cv, lengths,
                        paged_valid(lengths, ck.shape[1], window), num_heads, rope,
                        compute_dtype, ks, vs, dot_fn, ffn_fn)


def decode_token_paged_plain(h, weights, pool_k, pool_v, tables, lengths, active, *,
                             num_heads, rope=False, compute_dtype=torch.bfloat16,
                             k_scale=None, v_scale=None, window=None, dot_fn=None,
                             ffn_fn=None):
    """Plain version of :func:`decode_token_paged`: per layer, the step over
    the gathered view, then the fresh row scattered through the tables
    (``dot_fn`` / ``ffn_fn`` as in :func:`decode_token_slab_plain`)."""
    h = h.float()
    for i in range(pool_k.shape[0]):
        ks, vs = _at(k_scale, i), _at(v_scale, i)
        h, kq, vq, kqs, vqs = decode_block_paged_plain(
            h, _layer(weights, i), pool_k[i], pool_v[i], tables, lengths,
            num_heads=num_heads, rope=rope, compute_dtype=compute_dtype, k_scale=ks,
            v_scale=vs, window=window, dot_fn=dot_fn, ffn_fn=ffn_fn,
        )
        commit_paged_rows(pool_k[i], pool_v[i], kq, vq, tables, lengths, active, ks, vs,
                          kqs, vqs)
    return h, pool_k, pool_v


def verify_tokens_paged_plain(h, weights, pool_k, pool_v, tables, prefix_lens,
                              suffix_lens, active, *, num_heads, rope=False,
                              compute_dtype=torch.bfloat16, k_scale=None, v_scale=None,
                              window=None):
    """Plain version of :func:`verify_tokens_paged`: per layer,
    ``extend_paged``'s block with the fresh K/V rounded through the pool
    (the compute dtype, or quantized and dequantized to it) before
    attention, a row with no valid key giving 0, and the real rows of
    active slots scattered into the pool (and scales) after that layer's
    attention. Returns ``h_out`` [S, L, d] f32."""
    s, l, d = h.shape
    hkv, dh = pool_k.shape[-2], pool_k.shape[-1]
    dev = h.device
    positions = prefix_lens.long()[:, None] + torch.arange(l, device=dev)[None, :]
    extent = tables.shape[1] * pool_k.shape[2]
    valid = (
        (torch.arange(l, device=dev)[None, :] < suffix_lens[:, None])
        & active.bool()[:, None] & (positions < extent)
    )
    # A row with no valid key gives 0 (the JAX verify kernel's guard): no
    # cache position in its band, (prefix + li - W, prefix), and no fresh
    # row lj in (li - W, li] below the suffix length.
    li = torch.arange(l, device=dev)[None, :]
    first = (li - window + 1).clamp(min=0) if window is not None else torch.zeros_like(li)
    fresh_alive = first < suffix_lens[:, None]
    cache_alive = prefix_lens[:, None] > 0
    if window is not None:
        cache_alive = cache_alive & (li + 1 < window)
    alive = (fresh_alive | cache_alive)[:, :, None, None]
    h = h.float()
    cd = compute_dtype
    for i in range(pool_k.shape[0]):
        w = _layer(weights, i)
        ks, vs = _at(k_scale, i), _at(v_scale, i)
        hn = layernorm(h, w["ln1_scale"], w["ln1_bias"])
        q = dot(hn, w["wq"], cd).reshape(s, l, num_heads, dh)
        k = dot(hn, w["wk"], cd).reshape(s, l, hkv, dh)
        v = dot(hn, w["wv"], cd).reshape(s, l, hkv, dh)
        if rope:
            q, k = _rope(q, positions), _rope(k, positions)
        kq, vq, kqs, vqs, kf, vf = _fresh_rows(k, v, pool_k.dtype, cd)
        view = lambda p, sc: _cache_view(  # noqa: E731
            gather_block_view(p, tables), None if sc is None else gather_block_view(sc, tables),
            cd)
        attn = paged_extend_attention(q, kf, vf, view(pool_k[i], ks), view(pool_v[i], vs),
                                      positions, prefix_lens, suffix_lens, window)
        attn = torch.where(alive, attn, torch.zeros_like(attn))
        h = _ffn_plain(h + dot(attn.reshape(s, l, d), w["wo"], cd), w, cd)
        pairs = [(d[None], n[None]) for d, n in ((pool_k[i], kq), (pool_v[i], vq), (ks, kqs),
                                                  (vs, vqs)) if d is not None]
        scatter_rows(*zip(*pairs), tables, positions, valid)
    return h


# -- the cooperative kernel's launch plan --------------------------------------

# Mirrors of csrc/fused_decode.cu, so that the plan can be made without a
# card: threads of a CTA, columns of a weight tile, most tiles of one
# product a CTA takes, query rows a P·V pass accumulates, most x slots,
# 16-byte slots of a thread's K/V ring, most CTAs of a grid (the grid
# barrier's flags), most tiles x m-tiles of a product a CTA takes, most
# weight-ring slots. :func:`launch_plan` holds them against the library's
# ``coop_constants`` before the first launch.
COOP_THREADS = 384
TILE = 8
# The tile widths a product may take, in columns (TMA boxes of 16 to 128
# bytes a row, swizzled to match).
TILE_COLS = (64, 32, 16, 8)
MAX_TILES = 8
PV_ROWS = 5
MAX_SLOTS = 4
RING = 8
MAX_GRID = 1024
MAX_TILE_ROWS = 8
MAX_WSLOTS = 16
COOP_WARPS = COOP_THREADS // 32
# Most residual rows (slots x rows a slot) a launch takes: four m-tiles of 16.
# A verify takes any rows a slot up to this (the wrappers launch the slots
# in groups, :func:`slot_group`).
COOP_MAX_ROWS = 64
# Score tiles narrower than the cache extent are multiples of this many
# keys, rounded up to whole chunks of the attention's K/V stream (12 to
# 384 keys a chunk: COOP_THREADS over the lanes a key row takes).
KB_STEP = 96
# The weight ring the plan aims for: chunks are halved until this many fit.
WSLOTS_WANTED = 4
# The cooperative kernel's instantiations by number in the C interface
# (``coop_occupancy``).
COOP_KERNELS = {"decode_token_slab": 0, "decode_token_paged": 1, "verify_tokens_paged": 2,
                "decode_block_slab": 3, "decode_block_paged": 4}
# The cache types the kernel is built for, by their number in the C
# interface (``kv``): the compute dtype (0: bf16 in the bf16 build, f32 in
# the f32 one), and 1-byte codes with a f32 scale a row.
KV_TYPES = {torch.bfloat16: 0, torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
# The library of each compute dtype: one source, csrc/fused_decode.cu, built
# twice (ops/_build.py), so the two builds compile side by side.
LIBRARIES = {torch.bfloat16: "fused_decode", torch.float32: "fused_decode_f32"}
# Grid syncs a layer: after LN1 + q/k/v, attention, the output projection,
# LN2 + up, and the down projection (none after the last layer's).
PHASES = 5


@dataclasses.dataclass(frozen=True)
class Product:
    """One of a layer's four products, ``y = x @ W`` with W [k, n] of
    ``w_bytes`` an element (the compute dtype's): its column tiles of
    ``tile_cols`` (8 to 64, at most 128 bytes; a TMA box is one tile's row
    segment, so wider tiles mean fewer, longer copies), the most a CTA
    takes, the k-groups its warps
    split K into (within a CTA; partial sums added in k-group order), the
    chunks of ``d`` columns in which x is staged from global scratch (0:
    x is the CTA's own layernormed rows), and the rows ``k_rows`` of a
    weight chunk (a divisor of ``d``, whole TMA boxes of at most 256 rows):
    the CTA's tiles stream through the weight ring ``ceil(k / k_rows)``
    chunks a layer."""

    name: str
    k: int
    n: int
    tile_cols: int
    tiles: int
    tiles_per_cta: int
    k_groups: int
    chunks: int
    k_rows: int
    w_bytes: int = 2

    @property
    def subtiles_per_cta(self) -> int:
        """The CTA's MMA column tiles of ``TILE`` (its accumulators)."""
        return self.tiles_per_cta * self.tile_cols // TILE

    @property
    def chunk_bytes(self) -> int:
        return self.tiles_per_cta * self.k_rows * self.tile_cols * self.w_bytes


@dataclasses.dataclass(frozen=True)
class CoopPlan:
    """A launch of ``coop_step_kernel``: ``grid`` CTAs (SMs x
    ``occupancy``), ``rows`` = S x R residual rows in ``m_tiles`` MMA tiles
    of 16, the four products, ``tasks`` attention tasks (slot, KV head),
    ``syncs`` grid syncs a launch, the global ``scratch`` between phases
    (name -> (shape, dtype)) and the shared-memory ``layout`` (byte
    offsets; ``wslots`` weight slots of ``wslot`` bytes from 0, the
    layernorm's parameters at ``ln``, ``slots`` x slots of ``slot`` bytes
    from x0) of ``smem`` bytes; the attention's score tiles of ``kb`` keys
    (the cache extent: one block), and ``cs`` m-tile lanes of the warps
    (``COOP_WARPS / cs`` k-groups)."""

    grid: int
    occupancy: int
    rows: int
    m_tiles: int
    products: tuple[Product, ...]
    tasks: int
    syncs: int
    scratch: dict
    layout: dict
    smem: int
    kb: int
    cs: int

    def ints(self) -> list[int]:
        """The twenty-one ints the C interface takes (``struct Plan``)."""
        lay = self.layout
        return [self.grid, self.products[0].k, lay["wslot"], lay["wslots"],
                *(p.k_rows for p in self.products), *(p.tile_cols for p in self.products),
                lay["ln"], lay["x0"], lay["slot"], lay["slots"], lay["red"], lay["bar"],
                self.smem, self.kb, self.cs]


def _up(n: int, a: int) -> int:
    return -(-n // a) * a


def coop_plan(s, r, n_layers, d, hq, hkv, dh, f, c, mb, nsm, occupancy,
              smem_limit, ref_rows=None, *, w_bytes=2, kv_bytes=2) -> CoopPlan:
    """Lay out one cooperative launch of ``n_layers`` layers of the decode
    step (``r`` = 1; one layer for the per-layer step) or the verify
    (``r`` = L rows a slot) over ``s`` slots of a cache of extent ``c``
    (``mb`` table entries a slot when paged, else 0), on a card of ``nsm``
    SMs holding ``occupancy`` CTAs each and ``smem_limit`` bytes of shared
    memory a CTA. ``w_bytes``: the compute dtype's bytes (2 bf16, 4 f32),
    which the weights, the staged activations and the scratch between
    phases take, and which sets the dims a thread streams of a K/V row (8
    in bf16, 4 in f32; the whole row at head dim 4) and so the keys a chunk
    of the stream holds;
    ``kv_bytes``: the cache's (1 for codes, else the compute dtype's).
    ``ref_rows`` (default ``s * r``) sets the k-groups the
    products split K into, so a launch over part of a step's slots sums in
    the whole step's order (:func:`slot_group`). The attention task keeps
    score tiles of ``kb`` key positions: the whole extent ``c`` where the
    plan fits with it (one block, every key's score in shared memory at
    once), else the widest multiple of ``KB_STEP`` (in whole chunks) that
    leaves ``WSLOTS_WANTED`` weight slots (or two), and the kernel streams
    the cache in blocks of ``kb`` keys. This is the one derivation of the
    layout: the launcher checks only that its offsets are in order and in
    bounds. Raises ``ValueError`` with every reason when the shapes are
    outside the kernel's envelope."""
    rows = s * r
    why = []
    if w_bytes not in (2, 4) or kv_bytes not in (1, w_bytes):
        why.append(f"a compute dtype of 2 or 4 bytes over a cache of its own dtype or of "
                   f"1-byte codes (got {w_bytes} and {kv_bytes} bytes)")
    if hkv < 1 or hq % hkv:
        why.append(f"query heads ({hq}) a multiple of the KV heads ({hkv})")
    if dh not in HEAD_DIMS:
        why.append(f"head_dim 4, 8, 16, 32, 64 or 128 (got {dh})")
    if d != hq * dh:
        why.append(f"model_dim ({d}) = heads x head_dim ({hq} x {dh})")
    if d % 16:
        why.append(f"model_dim a multiple of 16 (got {d})")
    if f % 16:
        why.append(f"ffn width a multiple of 16 (got {f})")
    if not 1 <= rows <= COOP_MAX_ROWS or r < 1:
        why.append(f"1 to {COOP_MAX_ROWS} rows in all, slots x rows a slot (got {s} x {r})")
    if n_layers < 1:
        why.append("at least one layer")
    if mb and c % mb:
        why.append(f"a cache extent ({c}) of whole blocks ({mb} a slot)")
    grid = nsm * occupancy
    if not 1 <= grid <= MAX_GRID:
        why.append(f"a grid of 1 to {MAX_GRID} CTAs (got {nsm} SMs x {occupancy})")
    ref = rows if ref_rows is None else ref_rows
    if not rows <= ref <= COOP_MAX_ROWS:
        why.append(f"reference rows ({ref}) from the launch's rows ({rows}) to {COOP_MAX_ROWS}")
    if why:
        raise ValueError("the cooperative decode kernels do not take these shapes: they "
                         "need " + "; ".join(why))
    mt = -(-rows // 16)
    ref_mt = -(-ref // 16)
    cs = 4 if ref_mt > 2 else ref_mt  # m-tile lanes of the warps
    kg = COOP_WARPS // cs
    qw, kvw = hq * dh, hkv * dh
    shapes = (("qkv", d, qw + 2 * kvw, 0), ("out", qw, d, 1), ("up", d, f, 0),
              ("down", f, d, -(-f // d)))
    # Tile widths: the fewest columns the busiest CTA multiplies, then the
    # widest tile (q/k/v's tiles stay inside one of wq, wk, wv).
    widths = [min((w for w in TILE_COLS if n % w == 0 and w * w_bytes <= 128
                   and (name != "qkv" or kvw % w == 0)),
                  key=lambda w: (-(-(n // w) // grid) * w, -w))
              for name, _, n, _ in shapes]
    slot = rows * (d * w_bytes + 16)  # a row of x and 16 bytes of padding
    gr = hq // hkv * r

    def attn_bytes(kb):
        # The attention task's scratch: floats (q, the fresh rows, a score
        # tile of kb + r columns a row, the softmax's partials, the P·V
        # partials; with kb < c the running max and sum and the P·V sums of
        # the blocks), the table row, then each thread's ring of RING
        # 16-byte slots for streaming K and V.
        floats = (gr * dh + 2 * r * dh + gr * (kb + r) + 2 * COOP_WARPS * gr
                  + COOP_WARPS * PV_ROWS * dh + (2 * gr + gr * dh if kb < c else 0))
        return _up(4 * floats + 4 * mb, 16) + RING * COOP_THREADS * 16

    def layout(kb):
        """The products, the shared-memory layout, its bytes and a list of
        what is over the envelope, with score tiles of kb keys."""
        def boxed(kr):  # chunk rows that are whole TMA boxes of at most 256 rows
            while kr > 256 and kr % 256 and kr % 32 == 0:
                kr //= 2
            return kr

        # A chunk a product's x chunk, halved below while needed.
        k_rows = [boxed(d)] * 4

        def products():
            return tuple(Product(name, k, n, w, n // w, -(-(n // w) // grid), kg, chunks, kr,
                                 w_bytes)
                         for (name, k, n, chunks), w, kr in zip(shapes, widths, k_rows))

        prods = products()
        busy = [p for p in prods if p.subtiles_per_cta > MAX_TILES
                or p.subtiles_per_cta * mt > MAX_TILE_ROWS]
        red = max(p.subtiles_per_cta * kg * mt * 128 * 4 for p in prods)
        attn = attn_bytes(kb)

        def lay(wslot, wslots, slots):
            # ln: the next layernorm's scale and bias, [2][d] f32.
            ln = _up(wslots * wslot, 16)
            out = {"w0": 0, "wslot": wslot, "wslots": wslots, "ln": ln,
                   "x0": _up(ln + 8 * d, 128), "slot": slot, "slots": slots}
            # The x region holds the slots, or the attention's scratch, and the
            # partial sums at its end (over the slots' tail if need be: a
            # product's sums meet after its last read of x).
            region = _up(max(slots * slot, attn, red), 16)
            out["red"] = out["x0"] + region - red
            out["bar"] = out["x0"] + region
            # mbarriers: one an x slot, a full and an empty one a weight slot,
            # one for the layernorm's parameters
            return out, out["bar"] + 8 * (slots + 2 * wslots + 1)

        def wslot_of(ps):  # 1024-byte aligned: the TMA's 128-byte swizzle
            return _up(max(p.chunk_bytes for p in ps), 1024)

        def fits(wslots, slots):
            return lay(wslot_of(prods), wslots, slots)[1] <= smem_limit

        # Weight chunks: one a product's x chunk where WSLOTS_WANTED of them
        # fit beside one x slot, else the largest chunk halved (its rows stay
        # a whole number of k-steps dividing d) until they do; then as many x
        # slots as gelu(up) has chunks (up to MAX_SLOTS) that leave
        # WSLOTS_WANTED weight slots; then as many weight slots as fit.
        while not busy and not fits(WSLOTS_WANTED, 1):
            i = max(range(4), key=lambda j: prods[j].chunk_bytes)
            if k_rows[i] % 32:
                break
            k_rows[i] = boxed(k_rows[i] // 2)
            prods = products()
        slots = min(MAX_SLOTS, max(p.chunks for p in prods))
        while slots > 1 and not fits(WSLOTS_WANTED, slots):
            slots -= 1

        def ring(ps):  # weight slots that fit, and the bytes they keep in flight
            w = MAX_WSLOTS
            while w > 1 and lay(wslot_of(ps), w, slots)[1] > smem_limit:
                w -= 1
            return w, (w - 1) * wslot_of(ps)

        # Then smaller chunks while they keep more bytes in flight (a slot's
        # refill waits for its last chunk, so nw - 1 are in flight).
        wslots, flight = ring(prods)
        while not busy:
            i = max(range(4), key=lambda j: prods[j].chunk_bytes)
            if k_rows[i] % 32:
                break
            before = k_rows
            k_rows = [boxed(kr // 2) if j == i else kr for j, kr in enumerate(k_rows)]
            cand = products()
            cand_slots, cand_flight = ring(cand)
            if cand_flight <= flight:
                k_rows = before
                break
            prods, wslots, flight = cand, cand_slots, cand_flight
        lay_, smem = lay(wslot_of(prods), wslots, slots)
        over = [f"{p.name} needs {p.subtiles_per_cta} column tiles a CTA on a grid of {grid} "
                f"({TILE} columns each) over {mt} m-tiles (at most {MAX_TILES} tiles and "
                f"{MAX_TILE_ROWS} tiles x m-tiles)" for p in busy]
        if not busy and (smem > smem_limit or wslots < 2):
            over.append(f"{lay(lay_['wslot'], 2, slots)[1]} bytes of shared memory a CTA (at "
                        f"most {smem_limit}) with two weight slots of {lay_['wslot']}: x slots "
                        f"{slots} x {slot}, the attention task's {gr} score rows over "
                        f"{min(kb, c) + r} keys {attn}, partial sums {red}")
        return prods, lay_, smem, over

    kb = c
    prods, lay_, smem, over = layout(kb)
    # Keys a chunk of K/V: a thread streams 8 dims of a row in bf16, 4 in
    # f32, the whole row at Dh = 4.
    chunk = COOP_THREADS * min(dh, 4 if w_bytes == 4 else 8) // dh
    step = _up(KB_STEP, chunk)
    if over and not any("column tiles" in o for o in over) and c > step:
        # Score tiles narrower than the extent: the widest that leaves
        # WSLOTS_WANTED weight slots, else the widest that fits at all.
        steps = range(step, c, step)
        for need in (WSLOTS_WANTED, 2):
            lo_, hi_ = 0, len(steps)  # steps[:lo_] fit; bisect the first that does not
            while lo_ < hi_:
                mid = (lo_ + hi_) // 2
                got = layout(steps[mid])
                if not got[3] and got[1]["wslots"] >= need:
                    lo_ = mid + 1
                else:
                    hi_ = mid
            if lo_:
                kb = steps[lo_ - 1]
                prods, lay_, smem, over = layout(kb)
                break
        else:
            over = layout(step)[3]  # the reason at the narrowest tile
    if over:
        raise ValueError("the cooperative decode kernels do not take these shapes: "
                         + "; ".join(over))
    act = torch.float32 if w_bytes == 4 else torch.bfloat16
    scratch = {"qkv": ((rows, qw + 2 * kvw), torch.float32), "att": ((rows, qw), act),
               "gelu": ((rows, f), act)}
    return CoopPlan(grid, occupancy, rows, mt, prods, s * hkv, PHASES * n_layers - 1,
                    scratch, lay_, smem, kb, cs)


def slot_group(s, r, d, hq, hkv, dh, f, c, mb, nsm, smem_limit, *, w_bytes=2,
               kv_bytes=2) -> int:
    """The most of ``s`` slots of ``r`` rows each that one launch of the
    cooperative kernel takes at these widths on a card of ``nsm`` SMs:
    rows up to ``COOP_MAX_ROWS``, cut to the m-tiles of 16 rows that the
    busiest CTA's column tiles leave under ``MAX_TILE_ROWS`` (a wide
    model's products fill a CTA's tiles x m-tiles sooner: gpt-xl width
    takes 16 rows a launch, d=1024 32). A CTA's column tiles do not depend
    on the rows. ``w_bytes`` and ``kv_bytes``: the compute dtype's and the
    cache's element bytes (:func:`coop_plan`). The wrappers launch the
    slots in groups of this many, one
    after another: each group reads the weights once, and its k-groups are
    the first group's (``ref_rows``), so a grouped step sums in the order
    of the whole step wherever the whole step is one launch. Raises
    :func:`coop_plan`'s ``ValueError`` for shapes it refuses at that group
    (a head dim it does not take, more rows a slot than a launch takes,
    shared memory)."""
    nbytes = dict(w_bytes=w_bytes, kv_bytes=kv_bytes)
    one = coop_plan(1, 1, 1, d, hq, hkv, dh, f, c, mb, nsm, 1, smem_limit, **nbytes)
    busiest = max(p.subtiles_per_cta for p in one.products)
    most = min(COOP_MAX_ROWS, 16 * (MAX_TILE_ROWS // busiest))
    if r > most:
        raise ValueError(f"the cooperative decode kernels do not take these shapes: {r} rows a "
                         f"slot exceed the {most} rows a launch takes at these widths")
    group = min(s, most // r)
    coop_plan(group, r, 1, d, hq, hkv, dh, f, c, mb, nsm, 1, smem_limit, **nbytes)
    return group


_PLANS: dict = {}
_LIMITS: dict = {}
_GROUPS: dict = {}


def coop_constants(device, compute_dtype=torch.bfloat16) -> dict:
    """The constants of ``compute_dtype``'s library (``LIBRARIES``) on
    ``device`` (``coop_constants``): the mirrored ones by name, the compute
    dtype's bytes ``w_bytes`` and ``smem_limit``, the card's opt-in shared
    memory a block. Raises when a mirror differs from the library."""
    device = torch.device(device)
    lib_name = LIBRARIES[compute_dtype]
    got = _LIMITS.get((device.index, lib_name))
    if got is None:
        lib = _build.load(lib_name)
        lib.coop_constants.argtypes = [_PTR]
        lib.coop_constants.restype = _INT
        out = (ctypes.c_int * 11)()
        with torch.cuda.device(device):
            _build.check(lib.coop_constants(out), "coop_constants")
        names = ("COOP_THREADS", "TILE", "MAX_TILES", "PV_ROWS", "MAX_SLOTS", "RING",
                 "MAX_GRID", "MAX_TILE_ROWS", "MAX_WSLOTS", "w_bytes", "smem_limit")
        got = dict(zip(names, out))
        mirrors = {**globals(), "w_bytes": torch.empty((), dtype=compute_dtype).element_size()}
        wrong = [f"{nm} {mirrors[nm]} (library {v})" for nm, v in got.items()
                 if nm != "smem_limit" and mirrors[nm] != v]
        if wrong:
            raise RuntimeError(f"ops/fused_decode.py's mirrors of {lib_name} differ: "
                               + ", ".join(wrong))
        _LIMITS[(device.index, lib_name)] = got
    return got


def launch_plan(kernel, s, r, n_layers, d, hq, hkv, dh, f, c, mb, device,
                kv_dtype=torch.bfloat16, ref_rows=None,
                compute_dtype=torch.bfloat16) -> CoopPlan:
    """:func:`coop_plan` on ``device``: its SM count and opt-in shared
    memory, and the occupancy the kernel of ``compute_dtype`` built for
    the cache type ``kv_dtype`` reaches at the plan's shared memory (read
    once a shape)."""
    device = torch.device(device)
    key = (kernel, s, r, n_layers, d, hq, hkv, dh, f, c, mb, device.index, kv_dtype, ref_rows,
           LIBRARIES[compute_dtype])
    plan = _PLANS.get(key)
    if plan is None:
        nsm = torch.cuda.get_device_properties(device).multi_processor_count
        consts = coop_constants(device, compute_dtype)
        limit = consts["smem_limit"]
        shape = (s, r, n_layers, d, hq, hkv, dh, f, c, mb)
        nbytes = dict(w_bytes=consts["w_bytes"],
                      kv_bytes=torch.empty((), dtype=kv_dtype).element_size())
        plan = coop_plan(*shape, nsm, 1, limit, ref_rows, **nbytes)
        lib = _build.load(LIBRARIES[compute_dtype])
        lib.coop_occupancy.argtypes = [_INT, _INT, _INT]
        lib.coop_occupancy.restype = _INT
        occ = lib.coop_occupancy(COOP_KERNELS[kernel], KV_TYPES[kv_dtype], plan.smem)
        if occ < 0:
            _build.check(-occ, f"{kernel} occupancy")
        if occ < 1:
            raise RuntimeError(f"{kernel}: a CTA of {plan.smem} bytes of shared memory does "
                               "not fit on one SM")
        if occ > 1:
            plan = coop_plan(*shape, nsm, occ, limit, ref_rows, **nbytes)
        _PLANS[key] = plan
    return plan


# -- the CUDA kernels --------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _check_kernel_dtypes(compute_dtype, cache_dtype, k_scale, v_scale):
    """The kernels' envelope in dtypes: a bf16 model over a bf16 cache, an
    f32 model over an f32 cache, or either over 1-byte codes (int8,
    float8_e4m3fn) with their scales; raises for what they do not compute
    (the launch plan checks the shapes). RoPE is computed."""
    if compute_dtype not in LIBRARIES:
        raise NotImplementedError(
            f"the CUDA decode kernels compute in bf16 or f32; got {compute_dtype}"
        )
    if cache_dtype not in (compute_dtype, torch.int8, torch.float8_e4m3fn):
        raise NotImplementedError(
            f"the CUDA decode kernels take a cache of the compute dtype ({compute_dtype}), int8 "
            f"or float8_e4m3fn; got {cache_dtype}"
        )
    if (cache_dtype != compute_dtype) != (k_scale is not None and v_scale is not None):
        raise ValueError("a 1-byte cache needs its k_scale and v_scale, a cache of the compute "
                         "dtype none")


def _as(t, dtype, dev):
    """``t`` in ``dtype`` on ``dev``, contiguous; ``t`` itself when it is
    (attribute checks cost the host less than a ``.to`` call)."""
    if t.dtype == dtype and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=dtype).contiguous()


def _kernel_weights(weights, dev, compute_dtype):
    """The weights as the kernels take them, in ``WEIGHT_NAMES`` order:
    projections in the compute dtype, the rest f32, contiguous."""
    return [_as(weights[nm], compute_dtype if nm in PROJ_NAMES else torch.float32, dev)
            for nm in WEIGHT_NAMES]


def _ordered_ptrs(ws):
    """Weight pointers in the C interface's order."""
    by = dict(zip(WEIGHT_NAMES, ws))
    order = ("wq", "wk", "wv", "wo", "ln1_scale", "ln1_bias", "ln2_scale",
             "ln2_bias", "w_up", "b_up", "w_down", "b_down")
    return [by[nm].data_ptr() for nm in order]


def _i32(t):
    return _as(t, torch.int32, t.device)


def _stream(h):
    # The raw handle of the current stream (torch.cuda.current_stream builds
    # a Stream object on every call).
    return torch._C._cuda_getCurrentRawStream(h.device.index)


def _cpu_only(h):
    if h.device.type != "cpu":
        raise ValueError(f"decode runs on cuda or cpu, got {h.device}")


# The grid barrier's flags of each (device, stream): MAX_GRID words, one a
# CTA, and the epoch the last launch ended at, all kept by the kernels
# (csrc/fused_decode.cu grid_sync). Launches on one stream run one at a
# time, so each stream has its own.
_BARRIERS: dict = {}


def barrier_flags(device):
    """The address of the grid barrier's flags for launches on ``device``'s
    current stream (zeroed when first made)."""
    device = torch.device(device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    flags = _BARRIERS.get(key)
    if flags is None:
        flags = _BARRIERS[key] = torch.zeros(MAX_GRID + 1, dtype=torch.int32, device=device)
    return flags.data_ptr()


# What a launch of one shape on one stream reuses: the C function with its
# argtypes set, the plan's ints, the scratch between phases (each launch
# writes it before it reads it, and launches on one stream run in order)
# and the barrier's flags. Keyed by library, kernel, shape, device, stream.
_LAUNCHES: dict = {}
# Most slots a launch takes, below the planner's answer (None: the
# planner's). The tests set it to run a step in groups where it fits one
# launch; on the CPU it splits the plain versions' slots the same way.
MAX_GROUP: int | None = None


def _launch_record(kernel, shape, kv_dtype, compute_dtype, device, stream, ref_rows):
    lib = LIBRARIES[compute_dtype]
    key = (lib, kernel, shape, kv_dtype, device.index, stream, ref_rows)
    rec = _LAUNCHES.get(key)
    if rec is None:
        s, r, n, d, hq, hkv, dh, f, c, mb = shape
        plan = launch_plan(kernel, s, r, n, d, hq, hkv, dh, f, c, mb, device, kv_dtype, ref_rows,
                           compute_dtype)
        fn = getattr(_build.load(lib), kernel)
        scratch = [torch.empty(sh, dtype=dt, device=device) for sh, dt in plan.scratch.values()]
        ints = plan.ints()
        rec = _LAUNCHES[key] = (fn, (ctypes.c_int * len(ints))(*ints),
                                [t.data_ptr() for t in scratch], barrier_flags(device),
                                scratch)
        fn.restype = ctypes.c_int
    return rec


def _ptr(t):
    return None if t is None else t.data_ptr()


def _window_arg(window):
    """The kernels' window argument: 0 for none, else W ≥ 1."""
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def _grouped(fn, group, args, axes):
    """``fn(*args)`` over the slot groups ``[i, i + group)``: each tensor of
    ``args`` narrowed to the group along its slot axis (``axes``; None:
    shared, as a pool), the outputs of the groups joined along axis 0 (a
    tuple's elementwise; None stays None). One group: ``fn(*args)``
    itself. The groups' views write into the caches in place."""
    s = args[0].shape[0]
    if s <= group:
        return fn(*args)
    parts = [fn(*(t if ax is None or t is None else t.narrow(ax, i, min(group, s - i))
                  for t, ax in zip(args, axes)))
             for i in range(0, s, group)]
    if not isinstance(parts[0], tuple):
        return torch.cat(parts)
    return tuple(None if t[0] is None else torch.cat([movable(x) for x in t]).view(t[0].dtype)
                 for t in zip(*parts))


def _slot_groups(h, r, pool_k, tables, num_heads, weights, compute_dtype, scales):
    """``(group, ref_rows)``: on the card the slots a launch takes
    (:func:`slot_group`, read once a shape and dtypes, which are checked
    first; at most ``MAX_GROUP``) and the
    rows every group's k-groups are sized for (the planner's group's, so
    each row sums in one order however the slots are grouped); on the CPU
    ``MAX_GROUP`` (else every slot) and None."""
    s = h.shape[0]
    if not h.is_cuda:
        _cpu_only(h)
        return (s if MAX_GROUP is None else MAX_GROUP), None
    mb = 0 if tables is None else tables.shape[1]
    key = (s, r, h.shape[-1], num_heads, pool_k.shape[-2], pool_k.shape[-1],
           weights["w_up"].shape[-1], pool_k.shape[-3] * (mb or 1), mb, h.device.index,
           pool_k.dtype, compute_dtype, scales[0] is None)
    group = _GROUPS.get(key)
    if group is None:
        _check_kernel_dtypes(compute_dtype, pool_k.dtype, *scales)
        nsm = torch.cuda.get_device_properties(h.device).multi_processor_count
        consts = coop_constants(h.device, compute_dtype)
        group = _GROUPS[key] = slot_group(
            *key[:-4], nsm, consts["smem_limit"], w_bytes=consts["w_bytes"],
            kv_bytes=pool_k.element_size())
    return (group if MAX_GROUP is None else min(group, MAX_GROUP)), group * r


def _coop_launch(kernel, h, weights, pool_k, pool_v, scales, tables, r, n_layers, num_heads,
                 rope_on, compute_dtype, ptrs, dims, window=None, ref_rows=None):
    """Validate and launch ``kernel`` once over ``n_layers`` layers of the
    cache or pool (``scales`` = (k_scale, v_scale), None for a cache of the
    compute dtype): one
    group of slots. A slab cache may be a group's view of a larger one
    (each layer's slots contiguous, the layers ``stride(0)`` apart); a pool
    is contiguous. The C interface takes h_in, h_out, the weights, the
    caches and their scales, ``ptrs`` (the [S] int32 rows, the per-layer
    step's fresh rows), the scratch, the barrier's flags, the plan, the
    cache type, RoPE and the window (0: none; a windowed slab rolls), then
    ``dims`` (the model dims, then C, or NB, bs, MB). Returns h_out."""
    k_scale, v_scale = scales
    kv = KV_TYPES.get(pool_k.dtype)
    if compute_dtype not in LIBRARIES or kv is None or (kv == 0) != (
            pool_k.dtype == compute_dtype) or (kv != 0) != (
            k_scale is not None and v_scale is not None):
        _check_kernel_dtypes(compute_dtype, pool_k.dtype, k_scale, v_scale)  # the reason
    def dense(t):  # whole, or B6's slab each layer's slots (a group's view)
        return t[0].is_contiguous() if kernel == "decode_token_slab" else t.is_contiguous()

    if not (dense(pool_k) and dense(pool_v) and pool_k.stride() == pool_v.stride()):
        raise ValueError("the KV cache must be contiguous")
    if kv and not (dense(k_scale) and dense(v_scale) and k_scale.stride() == v_scale.stride()
                   and k_scale.stride(0) * pool_k.shape[-1] == pool_k.stride(0)
                   and k_scale.dtype == v_scale.dtype == torch.float32):
        raise ValueError("the KV scales must be contiguous float32")
    s, d = h.shape[0], h.shape[-1]
    hkv, dh = pool_k.shape[-2], pool_k.shape[-1]
    mb = 0 if tables is None else tables.shape[1]
    c = pool_k.shape[-3] * (mb or 1)  # slab length, or the tables' extent
    f = weights["w_up"].shape[-1]
    stream = _stream(h)
    fn, plan, scratch, flags, _ = _launch_record(
        kernel, (s, r, n_layers, d, num_heads, hkv, dh, f, c, mb), pool_k.dtype, compute_dtype,
        h.device, stream, ref_rows)
    ws = _kernel_weights(weights, h.device, compute_dtype)
    h = _as(h, torch.float32, h.device)
    out = torch.empty_like(h)
    args = [h.data_ptr(), out.data_ptr(), *_ordered_ptrs(ws), pool_k.data_ptr(),
            pool_v.data_ptr(), _ptr(k_scale), _ptr(v_scale), *ptrs, *scratch, flags]
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * (len(args) + 1) + [_INT] * (len(dims) + 3) + [_PTR]
    _build.check(fn(*args, plan, kv, int(rope_on), _window_arg(window), *dims, stream), kernel)
    _build.LAUNCHES[kernel] += 1
    return out


def _block_launch(kernel, h, weights, ck, cv, scales, tables, lengths, num_heads, rope,
                  compute_dtype, window=None, ref_rows=None):
    """B5 on the card, one group of slots: one layer's step. Returns
    ``(h_out, k_fresh, v_fresh, k_fresh_scale, v_fresh_scale)``."""
    s, hkv, dh = h.shape[0], ck.shape[-2], ck.shape[-1]
    kf = torch.empty((s, hkv, dh), dtype=ck.dtype, device=h.device)
    vf = torch.empty_like(kf)
    quant = scales[0] is not None
    ksf = torch.empty((s, hkv), dtype=torch.float32, device=h.device) if quant else None
    vsf = torch.empty_like(ksf) if quant else None
    lens = _i32(lengths)
    dims = [s, h.shape[-1], num_heads, hkv, dh, weights["w_up"].shape[-1]]
    if tables is None:
        ptrs, tail = [lens.data_ptr()], [ck.shape[1]]
    else:
        tables = _i32(tables)
        ptrs = [lens.data_ptr(), tables.data_ptr()]
        tail = [ck.shape[0], ck.shape[1], tables.shape[1]]
    out = _coop_launch(kernel, h, weights, ck, cv, scales, tables, 1, 1, num_heads, rope,
                       compute_dtype,
                       [*ptrs, kf.data_ptr(), vf.data_ptr(), _ptr(ksf), _ptr(vsf)], dims + tail,
                       window, ref_rows)
    return out, kf, vf, ksf, vsf


def decode_block_slab(h, weights, ck, cv, lengths, *, num_heads, rope=False,
                      compute_dtype=torch.bfloat16, k_scale=None, v_scale=None, window=None):
    """One GPT block's single-token step over one layer's slab cache.

    ``h`` [S, d] f32 residual rows, ``weights`` one layer's dict,
    ``ck``/``cv`` [S, C, Hkv, Dh] (PRE-write, not modified; the compute
    dtype, or 1-byte codes with ``k_scale``/``v_scale`` [S, C, Hkv] f32), ``lengths``
    [S] int write positions; ``window`` W: the slab is the rolling buffer
    of a windowed model (the caller commits at ``lengths % C``). Returns
    ``(h_out [S, d] f32, k_fresh, v_fresh [S, Hkv, Dh] as stored,
    k_fresh_scale, v_fresh_scale [S, Hkv] or None)``. One launch a group of
    slots (:func:`slot_group`)."""
    group, ref = _slot_groups(h, 1, ck, None, num_heads, weights, compute_dtype,
                              (k_scale, v_scale))

    def one(h, ck, cv, ks, vs, lengths):
        if not h.is_cuda:
            return decode_block_slab_plain(h, weights, ck, cv, lengths, num_heads=num_heads,
                                           rope=rope, compute_dtype=compute_dtype, k_scale=ks,
                                           v_scale=vs, window=window)
        return _block_launch("decode_block_slab", h, weights, ck, cv, (ks, vs), None, lengths,
                             num_heads, rope, compute_dtype, window, ref)

    return _grouped(one, group, (h, ck, cv, k_scale, v_scale, lengths), (0,) * 6)


def decode_token_slab(h, weights, ck, cv, lengths, active, *, num_heads,
                      rope=False, compute_dtype=torch.bfloat16, k_scale=None, v_scale=None,
                      window=None):
    """The whole model's single-token step over the slab cache, one launch
    a group of slots (:func:`slot_group`).

    ``h`` [S, d] f32 embedded rows, ``weights`` layer-stacked,
    ``ck``/``cv`` [n_layers, S, C, Hkv, Dh] (1-byte codes with
    ``k_scale``/``v_scale`` [n_layers, S, C, Hkv]), ``lengths`` [S] int,
    ``active`` [S] bool, ``window`` W (a rolling slab). Returns ``(h_out
    [S, d] f32, ck, cv)`` with the fresh rows (and scales) committed in
    place at the active rows' ``lengths`` (``% C`` when rolling)."""
    group, ref = _slot_groups(h, 1, ck, None, num_heads, weights, compute_dtype,
                              (k_scale, v_scale))

    def one(h, ck, cv, ks, vs, lengths, active):
        if not h.is_cuda:
            return decode_token_slab_plain(h, weights, ck, cv, lengths, active,
                                           num_heads=num_heads, rope=rope,
                                           compute_dtype=compute_dtype, k_scale=ks,
                                           v_scale=vs, window=window)[0]
        lens, act = _i32(lengths), _i32(active)
        n, s, c, hkv, dh = ck.shape
        # The group's slots from the cache's first, its layers ck.stride(0) apart.
        return _coop_launch("decode_token_slab", h, weights, ck, cv, (ks, vs), None, 1, n,
                            num_heads, rope, compute_dtype, [lens.data_ptr(), act.data_ptr()],
                            [n, s, h.shape[-1], num_heads, hkv, dh, weights["w_up"].shape[-1], c,
                             ck.stride(0) // ck.stride(1)], window, ref)

    out = _grouped(one, group, (h, ck, cv, k_scale, v_scale, lengths, active),
                   (0, 1, 1, 1, 1, 0, 0))
    return out, ck, cv


def decode_block_paged(h, weights, pool_k, pool_v, tables, lengths, *, num_heads,
                       rope=False, compute_dtype=torch.bfloat16, k_scale=None, v_scale=None,
                       window=None):
    """One GPT block's single-token step over one layer's block pool.

    ``pool_k``/``pool_v`` [NB, bs, Hkv, Dh] (PRE-write, not modified;
    1-byte codes with ``k_scale``/``v_scale`` [NB, bs, Hkv]), ``tables``
    [S, MB] int block ids, ``window`` W (absolute positions, the band
    masked), the rest as in :func:`decode_block_slab`. Returns ``(h_out
    [S, d] f32, k_fresh, v_fresh [S, Hkv, Dh], k_fresh_scale,
    v_fresh_scale)``; the caller commits with :func:`commit_paged_rows`."""
    group, ref = _slot_groups(h, 1, pool_k, tables, num_heads, weights, compute_dtype,
                              (k_scale, v_scale))

    def one(h, tables, lengths):
        if not h.is_cuda:
            return decode_block_paged_plain(h, weights, pool_k, pool_v, tables, lengths,
                                            num_heads=num_heads, rope=rope,
                                            compute_dtype=compute_dtype, k_scale=k_scale,
                                            v_scale=v_scale, window=window)
        return _block_launch("decode_block_paged", h, weights, pool_k, pool_v,
                             (k_scale, v_scale), tables, lengths, num_heads, rope,
                             compute_dtype, window, ref)

    return _grouped(one, group, (h, tables, lengths), (0, 0, 0))


def decode_token_paged(h, weights, pool_k, pool_v, tables, lengths, active, *,
                       num_heads, rope=False, compute_dtype=torch.bfloat16, k_scale=None,
                       v_scale=None, window=None):
    """The whole model's single-token step over the block pool, one launch
    a group of slots.

    ``pool_k``/``pool_v`` [n_layers, NB, bs, Hkv, Dh] (1-byte codes with
    ``k_scale``/``v_scale`` [n_layers, NB, bs, Hkv]), ``tables`` [S, MB],
    ``window`` W (absolute positions), the rest as in
    :func:`decode_token_slab`. Returns ``(h_out, pool_k, pool_v)`` with
    each active row's fresh K/V (and scales) committed in place at
    ``pool[l, tables[s, len // bs], len % bs]``."""
    group, ref = _slot_groups(h, 1, pool_k, tables, num_heads, weights, compute_dtype,
                              (k_scale, v_scale))

    def one(h, tables, lengths, active):
        if not h.is_cuda:
            return decode_token_paged_plain(h, weights, pool_k, pool_v, tables, lengths, active,
                                            num_heads=num_heads, rope=rope,
                                            compute_dtype=compute_dtype, k_scale=k_scale,
                                            v_scale=v_scale, window=window)[0]
        lens, act, tabs = _i32(lengths), _i32(active), _i32(tables)
        n, nb, bs, hkv, dh = pool_k.shape
        return _coop_launch("decode_token_paged", h, weights, pool_k, pool_v,
                            (k_scale, v_scale), tabs, 1, n, num_heads, rope, compute_dtype,
                            [lens.data_ptr(), act.data_ptr(), tabs.data_ptr()],
                            [n, h.shape[0], h.shape[-1], num_heads, hkv, dh,
                             weights["w_up"].shape[-1], nb, bs, tabs.shape[1]], window, ref)

    out = _grouped(one, group, (h, tables, lengths, active), (0, 0, 0, 0))
    return out, pool_k, pool_v


def verify_tokens_paged(h, weights, pool_k, pool_v, tables, prefix_lens, suffix_lens,
                        active, *, num_heads, rope=False, compute_dtype=torch.bfloat16,
                        k_scale=None, v_scale=None, window=None):
    """The speculation verify over the block pool, every layer in one
    launch a group of slots.

    ``h`` [S, L, d] f32 embedded draft rows (L ≤ ``COOP_MAX_ROWS``; the
    kernels take fewer at wide models, :func:`slot_group`) at positions
    ``prefix_lens[s] + li``; ``suffix_lens`` [S] real rows per slot;
    ``active`` [S] bool; ``weights`` layer-stacked; pools, scales and
    tables as in :func:`decode_token_paged`. Each row attends the pool
    STRICTLY below its slot's prefix length (read pre-write) and the
    slot's fresh rows ``lj <= li, lj < suffix_len``, rounded through the
    pool (the compute dtype, or quantized and dequantized). Each layer
    commits position ``prefix + li`` where active and ``li < suffix_len``,
    in place. With ``window`` W row li attends pool positions ``> prefix +
    li - W`` and fresh rows ``lj > li - W``. Returns ``h_out`` [S, L, d]
    f32; lengths and tables stay the caller's."""
    group, ref = _slot_groups(h, h.shape[1], pool_k, tables, num_heads, weights, compute_dtype,
                              (k_scale, v_scale))

    def one(h, tables, prefix_lens, suffix_lens, active):
        if not h.is_cuda:
            return verify_tokens_paged_plain(h, weights, pool_k, pool_v, tables, prefix_lens,
                                             suffix_lens, active, num_heads=num_heads,
                                             rope=rope, compute_dtype=compute_dtype,
                                             k_scale=k_scale, v_scale=v_scale, window=window)
        tabs = _i32(tables)
        plens, slens, act = _i32(prefix_lens), _i32(suffix_lens), _i32(active)
        n, nb, bs, hkv, dh = pool_k.shape
        s, l, d = h.shape
        return _coop_launch("verify_tokens_paged", h, weights, pool_k, pool_v,
                            (k_scale, v_scale), tabs, l, n, num_heads, rope, compute_dtype,
                            [tabs.data_ptr(), plens.data_ptr(), slens.data_ptr(),
                             act.data_ptr()],
                            [n, s, l, d, num_heads, hkv, dh, weights["w_up"].shape[-1], nb, bs,
                             tabs.shape[1]], window, ref)

    return _grouped(one, group, (h, tables, prefix_lens, suffix_lens, active), (0,) * 5)
