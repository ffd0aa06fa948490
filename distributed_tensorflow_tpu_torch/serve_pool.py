"""Host-side KV block pool of the paged server: allocator, prefix radix,
n-gram drafts.

A copy of the pure-Python half of ``distributed_tensorflow_tpu/serve_pool.py``
(the port imports nothing of the JAX package): ``blocks_for`` (:75),
``kv_position_bytes`` (:82), ``kv_block_bytes`` (:107),
``blocks_for_hbm_bytes`` (:124), :class:`BlockAllocator` (:156),
:class:`PrefixCache` (:222, without the event journal) and
:func:`lookup_draft` (:460). The fleet index waits for ROADMAP A8d.

- :class:`BlockAllocator` — a refcounted free list over the pool. A block
  is free (on the list) or held by one or more owners (a live slot, the
  prefix cache, or both); ``release`` returns it at refcount zero.
- :class:`PrefixCache` — a hash-consed radix over FULL prompt blocks: node
  key = (parent block id, that block's tokens), so a chain lookup is exact
  prefix matching. Only immutable full prompt blocks enter it, so sharing
  never copies. Eviction is LRU over leaves held by the cache alone.
- :func:`lookup_draft` — prompt-lookup speculative drafts from the
  request's own context, verified greedy-exact by the engine.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions."""
    if tokens < 0:
        raise ValueError(f"tokens must be >= 0, got {tokens}")
    return -(-tokens // block_size)


def kv_position_bytes(num_layers: int, kv_heads: int, head_dim: int, elem_bytes: int,
                      scale_bytes: int = 0) -> int:
    """Bytes ONE cached position occupies across the whole stack: K and V
    payload rows plus, for a quantized cache, ``scale_bytes`` (4 for the
    f32 scales) per KV head per tensor per layer."""
    if min(num_layers, kv_heads, head_dim, elem_bytes) < 1:
        raise ValueError("num_layers/kv_heads/head_dim/elem_bytes must all be >= 1")
    if scale_bytes < 0:
        raise ValueError(f"scale_bytes must be >= 0, got {scale_bytes}")
    return 2 * num_layers * kv_heads * (head_dim * elem_bytes + scale_bytes)


def kv_block_bytes(block_size: int, *, num_layers: int, kv_heads: int, head_dim: int,
                   elem_bytes: int, scale_bytes: int = 0) -> int:
    """Bytes one pool block occupies (payload and scales)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return block_size * kv_position_bytes(num_layers, kv_heads, head_dim, elem_bytes,
                                          scale_bytes)


def blocks_for_hbm_bytes(budget_bytes: int, block_size: int, *, num_layers: int,
                         kv_heads: int, head_dim: int, elem_bytes: int,
                         scale_bytes: int = 0) -> int:
    """Pool blocks a byte budget holds at the given element size (scales
    charged), so one ``kv_hbm_bytes`` gives a 1-byte pool about twice a
    bf16 pool's blocks."""
    bb = kv_block_bytes(block_size, num_layers=num_layers, kv_heads=kv_heads,
                        head_dim=head_dim, elem_bytes=elem_bytes, scale_bytes=scale_bytes)
    n = int(budget_bytes) // bb
    if n < 1:
        raise ValueError(
            f"HBM budget {budget_bytes} B holds no {bb} B block; raise the budget or "
            "shrink block_size"
        )
    return n


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical KV
    blocks: a block is on the free list iff its refcount is 0, ``alloc``
    never hands out a live block, and free + live partition the pool."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(num_blocks))
        self._ref = [0] * num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh blocks at refcount 1; ``MemoryError`` when the
        free list is short (admission checks ``can_alloc`` first)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n > len(self._free):
            raise MemoryError(f"pool exhausted: want {n} blocks, {len(self._free)} free")
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, bid: int) -> None:
        """One more owner for a LIVE block (a prefix-cache hit)."""
        if self._ref[bid] <= 0:
            raise ValueError(f"retain of free block {bid}")
        self._ref[bid] += 1

    def release(self, bid: int) -> bool:
        """Drop one owner; True when the block went back to the free list."""
        if self._ref[bid] <= 0:
            raise ValueError(f"release of free block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def reset(self) -> None:
        """Everything back to free."""
        self._free = deque(range(self.num_blocks))
        self._ref = [0] * self.num_blocks


class PrefixCache:
    """Hash-consed radix of full prompt blocks over a
    :class:`BlockAllocator`. The cache holds ONE reference on every
    registered block; eviction releases it, leaf-first, LRU, only for
    blocks nobody else holds."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = allocator
        self.block_size = block_size
        self._map: dict = {}  # (parent bid | -1, block tokens) -> bid
        self._key_of: dict = {}  # bid -> its radix key
        self._children: dict = {}  # bid -> registered child count
        self._lru: dict = {}  # bid -> last-touch tick
        self._tick = 0

    def __len__(self) -> int:
        return len(self._map)

    def matchable_blocks(self, prompt_len: int) -> int:
        """Full blocks of a ``prompt_len``-token prompt eligible for
        matching: one token short of the prompt, since the engine always
        prefills at least one suffix token."""
        return max(prompt_len - 1, 0) // self.block_size

    def match(self, tokens) -> list[int]:
        """Longest cached chain of full prompt blocks (root first). No
        refcount moves: the caller retains what it admits."""
        bs = self.block_size
        out: list[int] = []
        parent = -1
        self._tick += 1
        for i in range(self.matchable_blocks(len(tokens))):
            key = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            bid = self._map.get(key)
            if bid is None:
                break
            out.append(bid)
            self._lru[bid] = self._tick
            parent = bid
        return out

    def insert(self, tokens, block_ids: list[int], n_full: int) -> int:
        """Register the first ``n_full`` blocks of a prompt (``block_ids`` =
        the slot's block table). Cached links are skipped, so same-prefix
        admissions converge on one chain; each new block gains the cache's
        reference. Returns how many blocks were added."""
        bs = self.block_size
        parent = -1
        added = 0
        self._tick += 1
        for i in range(n_full):
            key = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            bid = self._map.get(key)
            if bid is None:
                bid = block_ids[i]
                self._map[key] = bid
                self._key_of[bid] = key
                self.allocator.retain(bid)
                if parent != -1:
                    self._children[parent] = self._children.get(parent, 0) + 1
                added += 1
            self._lru[bid] = self._tick
            parent = bid
        return added

    def evictable_blocks(self) -> int:
        """Radix entries whose only owner is the cache (refcount 1)."""
        return sum(1 for bid in self._key_of if self.allocator.refcount(bid) == 1)

    def evict(self, want_free: int) -> int:
        """Release cached leaves held by the cache alone, LRU first, until
        ``want_free`` blocks were freed or no candidate remains."""
        freed = 0
        while freed < want_free:
            candidates = [
                bid for bid in self._key_of
                if self._children.get(bid, 0) == 0 and self.allocator.refcount(bid) == 1
            ]
            if not candidates:
                break
            self._drop(min(candidates, key=lambda b: self._lru.get(b, 0)))
            freed += 1
        return freed

    def _drop(self, bid: int) -> None:
        key = self._key_of.pop(bid)
        del self._map[key]
        self._lru.pop(bid, None)
        self._children.pop(bid, None)
        if key[0] != -1:
            self._children[key[0]] -= 1
        self.allocator.release(bid)


def lookup_draft(context, max_draft: int, ngram: int = 2):
    """Prompt-lookup drafts: the tokens that followed the most recent PRIOR
    occurrence of the context's final ``ngram`` tokens, preferring the
    newest match with a full ``max_draft`` continuation. At most
    ``max_draft`` ints, possibly none."""
    ctx = np.asarray(context, np.int64)
    n = ctx.size
    if max_draft < 1 or n <= ngram:
        return []
    tail = ctx[n - ngram:]
    windows = np.lib.stride_tricks.sliding_window_view(ctx, ngram)
    hits = np.flatnonzero((windows[: n - ngram] == tail).all(axis=1))
    if hits.size == 0:
        return []
    full = hits[hits + ngram + max_draft <= n]
    start = int(full[-1]) if full.size else int(hits[-1])
    return [int(t) for t in ctx[start + ngram: start + ngram + max_draft]]
