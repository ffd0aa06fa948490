"""GPT-style causal decoder LM: the slab-serving subset, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/gpt.py`` ``GPTLM``:
config and validation (:212-402), ``init`` (:406), the forward pieces
``_embed_tokens`` / ``_block`` / ``_ffn`` / ``_logits`` / ``apply``
(:656-789), and the slot cache surface ``cache_len`` /
``empty_slot_cache`` / ``reset_slots`` / ``prefill_slots`` /
``decode_slots`` (:1268-1797) with its engine resolution (:1129-1204).

Architecture as there: token embed + learned positions (or RoPE) → N
pre-LN blocks (causal attention + tanh-GELU MLP, residuals) → final LN →
logits through the tied embedding. Products run on compute-dtype operands
with f32 accumulation; layernorm and softmax are f32.

Parameters are NamedTuples of tensors keyed like the JAX ones, so
``convert.py`` carries them across through numpy. Prefill attention goes
through the flash kernel when ``attention_impl="flash"`` (the dense plain
path otherwise); single-token decode goes through the fused decode
kernels. On a CUDA device a kernel launches or raises; on the CPU the
plain versions run. The slot cache is updated in place.

Not ported in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): MoE blocks and ``matmul_dtype`` (A5), the sliding window,
int8/fp8 KV caches and paged caches (A3). RoPE and GQA work on the plain
path; RoPE on the CUDA decode kernels is A3 too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.base import layernorm, rope
from distributed_tensorflow_tpu_torch.ops.attention import dense_attention
from distributed_tensorflow_tpu_torch.ops.flash_attention import (
    FLASH_MIN_LEN,
    flash_attention,
)
from distributed_tensorflow_tpu_torch.ops.fused_decode import (
    PROJ_NAMES,
    WEIGHT_NAMES,
    commit_slot_rows,
    decode_block_slab,
    decode_token_slab,
    dot,
)

# "fused" is the megakernel (one launch per token), "fused-layer" the
# per-layer kernel kept as its parity oracle (the JAX "pallas-layer").
DECODE_ENGINES = ("auto", "fused", "fused-layer")


class GPTBlockParams(NamedTuple):
    """One decoder block; every leaf carries a leading [num_layers] axis."""

    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor  # [n, d, Hq·Dh]
    wk: torch.Tensor  # [n, d, Hkv·Dh]
    wv: torch.Tensor
    wo: torch.Tensor  # [n, d, d]
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w_up: torch.Tensor  # [n, d, 4d]
    b_up: torch.Tensor
    w_down: torch.Tensor  # [n, 4d, d]
    b_down: torch.Tensor


class GPTLMParams(NamedTuple):
    embed: torch.Tensor  # [vocab, d] (also the tied LM head)
    pos: torch.Tensor  # [max_len, d]
    blocks: GPTBlockParams
    lnf_scale: torch.Tensor
    lnf_bias: torch.Tensor


class SlotKVCache(NamedTuple):
    """Per-slot serving cache: K/V [num_layers, S, cache_len, Hkv, Dh] in
    the compute dtype and each slot's written length [S] int32."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


class GPTLM:
    """tokens [B, L] int → next-token logits [B, L, vocab]."""

    def __init__(
        self,
        vocab_size: int = 256,
        max_len: int = 128,
        model_dim: int = 64,
        num_heads: int = 4,
        num_kv_heads: int | None = None,
        num_layers: int = 2,
        compute_dtype=torch.bfloat16,
        attention_impl: str = "xla",
        window: int | None = None,
        moe_experts: int | None = None,
        pos_embedding: str = "learned",
        flash_min_len: int | None = None,
        matmul_dtype: str | None = None,
        decode_engine: str = "auto",
    ):
        if model_dim % num_heads:
            raise ValueError(
                f"model_dim {model_dim} must be a multiple of num_heads {num_heads}"
            )
        # "xla" keeps the JAX package's name for the dense attention path.
        if attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"unknown attention_impl {attention_impl!r}; xla|flash"
            )
        if window is not None:
            raise NotImplementedError(
                "sliding-window attention is not ported yet (ROADMAP A3)"
            )
        if moe_experts is not None:
            raise NotImplementedError("MoE blocks are not ported yet (ROADMAP A5)")
        if matmul_dtype is not None:
            raise NotImplementedError(
                "matmul_dtype projections are not ported yet (ROADMAP A5)"
            )
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"unknown pos_embedding {pos_embedding!r}; learned|rope"
            )
        if pos_embedding == "rope" and (model_dim // num_heads) % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {model_dim // num_heads}"
            )
        if num_kv_heads is None:
            num_kv_heads = num_heads
        if num_kv_heads < 1:
            raise ValueError(f"num_kv_heads must be >= 1, got {num_kv_heads}")
        if num_heads % num_kv_heads:
            raise ValueError(
                f"num_heads {num_heads} must be a multiple of num_kv_heads "
                f"{num_kv_heads}"
            )
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be torch.float32 or torch.bfloat16, got "
                f"{compute_dtype!r}"
            )
        if decode_engine not in DECODE_ENGINES:
            raise ValueError(
                f"unknown decode_engine {decode_engine!r}; one of {DECODE_ENGINES}"
            )
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = model_dim // num_heads
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.pos_embedding = pos_embedding
        self.flash_min_len = flash_min_len
        self.decode_engine = decode_engine

    # -- init --------------------------------------------------------------

    def init(self, seed: int = 1, device=None) -> GPTLMParams:
        """Fresh parameters from ``seed`` (a CPU ``torch.Generator``, then
        moved to ``device``). The draws are PyTorch's, not JAX's; the shapes,
        scales and zero-initialized residual projections (``wo``,
        ``w_down``) are the JAX package's."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        d, n = self.model_dim, self.num_layers
        kvw = self.num_kv_heads * self.head_dim

        def normal(shape, std=1.0):
            return torch.randn(shape, generator=gen) * std

        def dense(shape):
            return normal(shape) / shape[-2] ** 0.5

        blocks = GPTBlockParams(
            ln1_scale=torch.ones(n, d),
            ln1_bias=torch.zeros(n, d),
            wq=dense((n, d, d)),
            wk=dense((n, d, kvw)),
            wv=dense((n, d, kvw)),
            wo=torch.zeros(n, d, d),
            ln2_scale=torch.ones(n, d),
            ln2_bias=torch.zeros(n, d),
            w_up=dense((n, d, 4 * d)),
            b_up=torch.zeros(n, 4 * d),
            w_down=torch.zeros(n, 4 * d, d),
            b_down=torch.zeros(n, d),
        )
        pos = (
            normal((self.max_len, d), 0.02)
            if self.pos_embedding == "learned"
            else torch.zeros(self.max_len, d)
        )
        params = GPTLMParams(
            embed=normal((self.vocab_size, d), 0.02),
            pos=pos,
            blocks=blocks,
            lnf_scale=torch.ones(d),
            lnf_bias=torch.zeros(d),
        )
        return map_params(params, lambda t: t.to(dev))

    def serving_params(self, params: GPTLMParams) -> GPTLMParams:
        """The block projections pre-cast to the compute dtype, everything
        else as it was. Products cast their operands to the compute dtype
        anyway, so the math is unchanged; a server does this once instead
        of casting ~50 MB of weights per decoded token."""
        blocks = params.blocks._replace(
            **{nm: getattr(params.blocks, nm).to(self.compute_dtype) for nm in PROJ_NAMES}
        )
        return params._replace(blocks=blocks)

    # -- shared pieces -----------------------------------------------------

    def _dot(self, x, w):
        return dot(x, w, self.compute_dtype)

    def _attend(self, q, k, v, kv_lens=None):
        min_len = FLASH_MIN_LEN if self.flash_min_len is None else self.flash_min_len
        if self.attention_impl == "flash" and q.shape[1] >= min_len:
            return flash_attention(q, k, v, causal=True, kv_lens=kv_lens)
        return dense_attention(q, k, v, causal=True, kv_lens=kv_lens)

    def _embed_tokens(self, params, tokens, positions):
        """Token embedding plus the learned position rows. Positions are
        clamped to the table (the JAX ``jnp.take`` never raises either);
        only rows the caller discards can reach the clamp."""
        if tokens.ndim > 1 and tokens.shape[1] > self.max_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_len {self.max_len}"
            )
        h = params.embed[tokens.long()]
        if self.pos_embedding == "learned":
            h = h + params.pos[positions.long().clamp(0, self.max_len - 1)]
        return h

    def _ffn(self, blk, hn2):
        up = self._dot(hn2, blk.w_up) + blk.b_up
        return self._dot(F.gelu(up, approximate="tanh"), blk.w_down) + blk.b_down

    def _block(self, blk, h, positions, kv_lens=None):
        """Block forward on h [B, L, d]; also returns this block's k/v
        [B, L, Hkv, Dh] (f32) for the cache."""
        b, l, d = h.shape
        hn = layernorm(h, blk.ln1_scale, blk.ln1_bias)
        kv_shape = (b, l, self.num_kv_heads, self.head_dim)
        q = self._dot(hn, blk.wq).reshape(b, l, self.num_heads, self.head_dim)
        k = self._dot(hn, blk.wk).reshape(kv_shape)
        v = self._dot(hn, blk.wv).reshape(kv_shape)
        if self.pos_embedding == "rope":
            q, k = rope(q, positions), rope(k, positions)
        attn = self._attend(q, k, v, kv_lens)
        h = h + self._dot(attn.reshape(b, l, d), blk.wo)
        hn2 = layernorm(h, blk.ln2_scale, blk.ln2_bias)
        return h + self._ffn(blk, hn2), (k, v)

    def _logits(self, p: GPTLMParams, h):
        hf = layernorm(h, p.lnf_scale, p.lnf_bias)
        return self._dot(hf, p.embed.T)

    def apply(self, params: GPTLMParams, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] int → logits [B, L, vocab] f32, causal."""
        l = tokens.shape[1]
        positions = torch.arange(l, device=tokens.device)
        h = self._embed_tokens(params, tokens, positions)
        for i in range(self.num_layers):
            h, _ = self._block(layer_params(params.blocks, i), h, positions)
        return self._logits(params, h)

    # -- slot-wise decoding (the serving surface, serve.py) ----------------

    @property
    def cache_len(self) -> int:
        """Static KV-cache length per layer (``max_len``; the windowed
        rolling buffer is not ported)."""
        return self.max_len

    def empty_slot_cache(self, slots: int, kv_dtype: str = "bf16", *,
                         device=None) -> SlotKVCache:
        """A vacant ``slots``-row cache (lengths all zero = free). The
        "bf16" layout stores the compute dtype, as in the JAX package."""
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if kv_dtype != "bf16":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} caches are not ported yet (ROADMAP A3)"
            )
        dev = resolve_device(device)
        shape = (self.num_layers, slots, self.cache_len, self.num_kv_heads,
                 self.head_dim)
        return SlotKVCache(
            k=torch.zeros(shape, dtype=self.compute_dtype, device=dev),
            v=torch.zeros(shape, dtype=self.compute_dtype, device=dev),
            lengths=torch.zeros(slots, dtype=torch.int32, device=dev),
        )

    def reset_slots(self, cache: SlotKVCache, free: torch.Tensor) -> SlotKVCache:
        """Mark slots free (``free`` [S] bool): their lengths drop to 0; the
        stale K/V bytes stay and are unreachable past ``lengths``."""
        return cache._replace(
            lengths=torch.where(free, torch.zeros_like(cache.lengths), cache.lengths)
        )

    def prefill_slots(self, params, cache: SlotKVCache, tokens, lengths, admit):
        """Batched ragged prefill INTO slots: run the right-padded prompt
        block [S, L] (real lengths [S], each ≥ 1) once and, for rows with
        ``admit`` True, replace the slot's cache rows (positions ≥ L zeroed)
        and its length; other rows keep their state bit for bit. Returns
        (logits at each row's last real position [S, vocab], the cache —
        its tensors updated in place)."""
        s, l = tokens.shape
        c = self.cache_len
        if l > c:
            raise ValueError(f"prompt block {l} exceeds the cache length {c}")
        positions = torch.arange(l, device=tokens.device)
        h = self._embed_tokens(params, tokens, positions)
        m = admit.bool()[:, None, None, None]
        for i in range(self.num_layers):
            h, (k, v) = self._block(
                layer_params(params.blocks, i), h, positions, kv_lens=lengths
            )
            for dst, src in ((cache.k[i], k), (cache.v[i], v)):
                new = F.pad(src.to(dst.dtype), (0, 0, 0, 0, 0, c - l))
                dst.copy_(torch.where(m, new, dst))
        cache.lengths.copy_(
            torch.where(admit.bool(), lengths.to(cache.lengths.dtype), cache.lengths)
        )
        rows = torch.arange(s, device=h.device)
        h_last = h[rows, (lengths.long() - 1).clamp(min=0)]
        return self._logits(params, h_last), cache

    def _resolve_decode_engine(self, engine: str | None) -> str:
        """The per-call override (None → the model's knob) resolved to
        "fused" or "fused-layer". "auto" is the megakernel; on the CPU
        either engine runs its plain version."""
        e = self.decode_engine if engine is None else engine
        if e not in DECODE_ENGINES:
            raise ValueError(f"unknown decode engine {e!r}; one of {DECODE_ENGINES}")
        return "fused" if e == "auto" else e

    def decode_slots(self, params, token, cache: SlotKVCache, active=None, *,
                     engine: str | None = None):
        """Append one token per slot: token [S] int at each slot's own
        position. Returns (logits [S, vocab] f32, cache with ``lengths``
        advanced where active). Inactive rows are not written and their
        logits are garbage to discard; a row already at ``cache_len`` is
        never written either, so callers bound their own trip count as the
        server does (no per-token host check)."""
        s = token.shape[0]
        act = (
            torch.ones(s, dtype=torch.bool, device=token.device)
            if active is None
            else active.bool()
        )
        h = self._embed_tokens(params, token[:, None], cache.lengths[:, None])[:, 0]
        kw = dict(
            num_heads=self.num_heads,
            rope=self.pos_embedding == "rope",
            compute_dtype=self.compute_dtype,
        )
        if self._resolve_decode_engine(engine) == "fused":
            weights = {nm: getattr(params.blocks, nm) for nm in WEIGHT_NAMES}
            h, _, _ = decode_token_slab(
                h, weights, cache.k, cache.v, cache.lengths, act, **kw
            )
        else:
            for i in range(self.num_layers):
                weights = {nm: getattr(params.blocks, nm)[i] for nm in WEIGHT_NAMES}
                h, kq, vq = decode_block_slab(
                    h, weights, cache.k[i], cache.v[i], cache.lengths, **kw
                )
                commit_slot_rows(cache.k[i], cache.v[i], kq, vq, cache.lengths, act)
        new_cache = cache._replace(lengths=cache.lengths + act.to(cache.lengths.dtype))
        return self._logits(params, h), new_cache


def layer_params(blocks: GPTBlockParams, i: int) -> GPTBlockParams:
    """Layer ``i`` of the stacked block parameters."""
    return GPTBlockParams(*(t[i] for t in blocks))


def map_params(params: GPTLMParams, fn) -> GPTLMParams:
    """Apply ``fn`` to every tensor of a params tree."""
    return GPTLMParams(
        embed=fn(params.embed),
        pos=fn(params.pos),
        blocks=GPTBlockParams(*(fn(t) for t in params.blocks)),
        lnf_scale=fn(params.lnf_scale),
        lnf_bias=fn(params.lnf_bias),
    )
