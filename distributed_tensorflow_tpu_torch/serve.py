"""Batched LM serving over slots: bucketed prefill, chunked decode, continuous
batching, and the paged engine with prefix caching and speculation — the
slab and paged engines of ``distributed_tensorflow_tpu/serve.py``
``TextServer``, in PyTorch.

Ported: ``GenerationConfig`` (:76), the knobs and their validation
(:315-505), the bucket defaults (:550-559) and ``bucket_for``, ``submit``,
``_admit_slab`` (:1723), ``_plan_admission`` (:1237), ``_admit_paged``
(:1566), ``_prefill_wave`` (:1648), ``_release_slot`` (:1780),
``_spec_dispatch`` (:1915), ``step`` (:1981), ``result``, ``generate`` and
``serve_text``, the chunk loop (:902-949), the paged prefill and verify
graphs (:787-900) and ``_pick`` (:681-713).

- **Bucketed prefill**: prompts pad to a few length buckets and prefill
  batched across the slots with ragged masking (``GPTLM.prefill_slots``;
  on the card its attention is the flash kernel).
- **Chunked decode**: ``chunk`` single-token steps run as a Python loop on
  the device (the megakernel per step, the pick in-graph on tensors);
  tokens and validity stay on the device and come back in ONE host fetch
  per chunk — no per-token ``.item()``.
- **Continuous batching**: queued requests fill freed slots at chunk
  boundaries; each slot is an independent request at its own position.
- **Paged cache** (``paged=True``): K/V live in one pool of
  ``block_size``-position blocks shared by all slots, each slot mapping
  its positions through a block table. Admission reserves
  ``ceil((prompt + max_new) / block_size)`` blocks (never overcommits, so
  generation never runs out mid-flight), minus prefix-cache hits, with no
  head-of-line blocking. With ``prefix_caching`` the full prompt blocks
  enter a radix at plan time; a later request with the same prefix maps
  the same physical blocks and prefills only its suffix, and same-round
  dependents prefill in a later wave than the writer.
- **Speculation** (``spec_draft > 0``, paged only): per greedy slot a
  prompt-lookup draft (``serve_pool.lookup_draft``), then ONE verify pass
  (``GPTLM.verify_paged``) scores every draft position and greedy-exact
  acceptance emits ``accepted + 1`` tokens, so streams are the greedy
  streams. Sampled slots ride at draft 0. A tick with no greedy resident
  runs the chunk loop.

Sampling uses one ``torch.Generator`` per request, seeded from
``GenerationConfig.seed`` and advanced once per emitted token by that
request alone, so a sampled stream depends on its seed alone, not on what
shares the batch or which engine serves it. (The bits differ from JAX's
PRNG, so sampled streams are never compared with the JAX package.) Greedy
streams equal in-process greedy decoding token for token.

- **Sliding-window models** (``GPTLM(window=W)``): the slab keeps
  ``cache_len = min(W, max_len)`` rows a slot as a rolling buffer, so its
  K/V bytes (``kv_slot_bytes``) are ``W / max_len`` of a full slab's; the
  paged layout keeps FULL history (absolute positions, the band masked),
  so for ``W << max_len`` the default pool is ~``max_len / W`` times the
  slab's K/V bytes: size ``kv_blocks`` explicitly there. Admission budgets
  ``prompt + max_new`` against ``max_len`` either way.
- **Quantized KV** (``kv_dtype="int8"|"fp8"``): the slab cache or the pool
  stores 1-byte codes with a f32 scale a row (``GPTLM.empty_slot_cache``);
  ``kv_hbm_bytes`` sizes the pool from a byte budget at that element size
  (``serve_pool.blocks_for_hbm_bytes``), scales charged. The radix shares a
  block's scales with the block.

- **Weight-only quantized decode** (``decode_matmul_dtype="int8"|"fp8"``):
  the projections are quantized once at construction
  (``GPTLM.decode_weights``) and that tree serves every path (prefill,
  decode, verify), so streams are the in-process decode's of the quantized
  weights; it composes with ``kv_dtype`` and ``spec_draft``. Such a tree,
  a MoE model and a ``matmul_dtype`` model are outside the decode kernels:
  "auto" serves them on "xla" (``TextServer.engine`` says which engine
  was resolved), "fused" and "fused-layer" are refused at construction.

Waiting for later slices: deadlines and shedding,
weight swap, drain, KV export/import, and wiring the event journal, the metrics
registry and its exporter into the server (A3.6). ``counters`` keeps the JAX
package's pool and speculation counter names.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, GPTLMParams, map_params
from distributed_tensorflow_tpu_torch.ops.fused_decode import coop_constants
from distributed_tensorflow_tpu_torch.ops.quantized import KV_DTYPES, MATMUL_DTYPES, kv_elem_bytes
from distributed_tensorflow_tpu_torch.serve_pool import (
    BlockAllocator,
    PrefixCache,
    blocks_for,
    blocks_for_hbm_bytes,
    kv_position_bytes,
    lookup_draft,
)

__all__ = ["GenerationConfig", "TextServer"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Per-request decoding knobs. ``greedy=True`` takes the argmax;
    ``greedy=False`` samples from ``logits/temperature`` within the
    ``top_p`` nucleus with a generator seeded by ``seed``. ``eos_id`` stops
    a request once emitted (the EOS token is included); None generates
    exactly ``max_new`` tokens."""

    max_new: int = 64
    greedy: bool = True
    temperature: float = 1.0
    top_p: float = 1.0
    seed: int = 0
    eos_id: int | None = None

    def validate(self, vocab_size: int) -> None:
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.eos_id is not None and not 0 <= self.eos_id < vocab_size:
            raise ValueError(f"eos_id must be in [0, {vocab_size}), got {self.eos_id}")


class _Request:
    __slots__ = ("rid", "tokens", "config", "out", "done", "gen",
                 "t_submit", "t_first")

    def __init__(self, rid, tokens, config):
        self.rid = rid
        self.tokens = tokens
        self.config = config
        self.out: list[int] = []
        self.done = False
        self.gen: torch.Generator | None = None  # set at admission (sampled)
        self.t_submit = time.perf_counter()
        self.t_first = None


class TextServer:
    """Continuous-batching text server over a fixed bank of request slots.

    Submit requests (:meth:`submit` / :meth:`generate` / :meth:`serve_text`)
    and drive the engine with :meth:`step` (one admission round + one
    ``chunk``-step decode, or one speculative verify) until :meth:`idle`.
    Runs on ``cuda`` unless ``device="cpu"`` is passed; without a CUDA
    device construction raises.

    Paged knobs (as in the JAX package): ``paged``, ``block_size``,
    ``kv_blocks`` (default ``slots × ceil(max_len / block_size)``, the slab
    footprint) or ``kv_hbm_bytes`` (a byte budget, ``kv_dtype``'s element
    size and scales charged), ``prefix_caching``, ``spec_draft`` (draft
    tokens per verify, 0 = off; needs ``paged``) and ``spec_ngram``.
    ``kv_dtype`` "bf16" | "int8" | "fp8" picks the cache's storage (slab or
    pool). ``decode_matmul_dtype`` None | "int8" | "fp8" quantizes the
    projection weights once for weight-only decode. ``decode_engine`` None
    defers to the model's knob; "xla" is the plain decode, taken when named
    or when "auto" meets a model outside the kernels (MoE, ``matmul_dtype``,
    quantized weights); ``engine`` is the one resolved. On the card a model
    or shape that
    the server's decode kernels do not take (a head dim they are not built
    for, a verify of more rows a slot than a launch takes, shared memory)
    is refused here, at construction, with the reason
    (``GPTLM._decode_unsupported_reason``); bf16 and f32 models are both
    served on the kernels."""

    def __init__(
        self,
        model: GPTLM,
        params: GPTLMParams,
        tokenizer=None,
        *,
        slots: int = 8,
        buckets: tuple[int, ...] | None = None,
        chunk: int = 32,
        paged: bool = False,
        block_size: int = 16,
        kv_blocks: int | None = None,
        kv_hbm_bytes: int | None = None,
        kv_dtype: str = "bf16",
        decode_matmul_dtype: str | None = None,
        decode_engine: str | None = None,
        prefix_caching: bool = True,
        spec_draft: int = 0,
        spec_ngram: int = 2,
        device=None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; one of {KV_DTYPES}")
        if decode_matmul_dtype is not None and decode_matmul_dtype not in MATMUL_DTYPES:
            raise ValueError(
                f"unknown decode_matmul_dtype {decode_matmul_dtype!r}; None or one of "
                f"{MATMUL_DTYPES}"
            )
        if kv_hbm_bytes is not None and not paged:
            raise ValueError("kv_hbm_bytes sizes the paged block pool; pass paged=True")
        if kv_hbm_bytes is not None and kv_blocks is not None:
            raise ValueError(
                "pass kv_blocks or kv_hbm_bytes, not both (kv_hbm_bytes derives kv_blocks "
                "from the element size)"
            )
        if spec_draft < 0:
            raise ValueError(f"spec_draft must be >= 0, got {spec_draft}")
        if spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if spec_draft and not paged:
            raise ValueError(
                "speculative decoding requires the paged cache (paged=True): "
                "the verify pass extends through block tables"
            )
        self.device = resolve_device(device)
        self.model = model
        params = map_params(params, lambda t: t.to(self.device))
        # Weight-only decode: quantized once, and that tree serves every path.
        self.decode_matmul_dtype = decode_matmul_dtype
        if decode_matmul_dtype is not None:
            params = model.decode_weights(params, decode_matmul_dtype)
        # Unknown names, and a kernel engine for what no kernel serves, raise.
        self.engine = model._resolve_decode_engine(decode_engine, params)
        self.decode_engine = decode_engine
        if self.device.type == "cuda" and self.engine != "xla":
            self._refuse_unsupported(model, self.engine, slots, paged, block_size, spec_draft,
                                     kv_dtype)
        self.params = model.serving_params(params)
        self.tokenizer = tokenizer
        self.slots = slots
        self.chunk = chunk
        self.paged = paged
        self.block_size = int(block_size)
        self.spec_draft = int(spec_draft)
        self.spec_ngram = int(spec_ngram)
        self.kv_dtype = kv_dtype
        # What one position and one block cost, scales included.
        geometry = dict(num_layers=model.num_layers, kv_heads=model.num_kv_heads,
                        head_dim=model.head_dim,
                        elem_bytes=kv_elem_bytes(kv_dtype, model.compute_dtype),
                        scale_bytes=0 if kv_dtype == "bf16" else 4)
        self.kv_position_bytes = kv_position_bytes(**geometry)
        self.kv_block_bytes = self.kv_position_bytes * self.block_size
        # A slot's K/V bytes: the slab's cache_len rows (a windowed model's
        # rolling buffer), or the blocks of its table (full history).
        self.kv_slot_bytes = (
            model.paged_blocks_per_slot(self.block_size) * self.kv_block_bytes
            if paged else model.cache_len * self.kv_position_bytes)
        self._prefix: PrefixCache | None = None
        if paged:
            nb_slot = model.paged_blocks_per_slot(self.block_size)
            if kv_hbm_bytes is not None:
                self.kv_blocks = blocks_for_hbm_bytes(kv_hbm_bytes, self.block_size, **geometry)
            else:
                self.kv_blocks = int(kv_blocks) if kv_blocks is not None else slots * nb_slot
            if self.kv_blocks < 1:
                raise ValueError(f"kv_blocks must be >= 1, got {self.kv_blocks}")
            self._alloc = BlockAllocator(self.kv_blocks)
            if prefix_caching:
                self._prefix = PrefixCache(self._alloc, self.block_size)
            # Host-authoritative block tables (copied to the device at each
            # prefill) and each slot's held blocks, released at completion.
            self._host_tables = np.zeros((slots, nb_slot), np.int32)
            self._slot_blocks: list[list[int] | None] = [None] * slots
        else:
            self.kv_blocks = 0
        if buckets is None:
            # Doubling buckets up to max_len-1 (a prompt always leaves at
            # least one position of generation room): 16, 32, ...
            buckets, b = [], 16
            while b < model.max_len:
                buckets.append(min(b, model.max_len - 1))
                b *= 2
            if not buckets or buckets[-1] != model.max_len - 1:
                buckets.append(model.max_len - 1)
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if buckets[0] < 1 or buckets[-1] > model.max_len:
            raise ValueError(
                f"buckets must lie in [1, max_len={model.max_len}]: {buckets}"
            )
        self.buckets = buckets
        self._queue: deque[_Request] = deque()
        self._slot_req: list[_Request | None] = [None] * slots
        self._next_rid = 0
        self._results: dict[int, _Request] = {}
        # Host-clock totals of the dispatches (each ends in its D2H fetch).
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0,
                       "decode_tokens": 0, "verify_s": 0.0, "verify_ticks": 0,
                       "verify_tokens": 0}
        # The JAX package's pool and speculation counters (its metrics
        # registry waits for ROADMAP A3.6).
        self.counters = {"prefix_cache_hits": 0, "prefix_cache_misses": 0,
                         "spec_tokens_proposed": 0, "spec_tokens_accepted": 0,
                         "kv_blocks_used": 0}
        # Per finished request: ttft_s, latency_s, tokens (for reports).
        self.stats: dict[int, dict] = {}
        dev, s = self.device, slots
        self._cache = (
            model.empty_paged_cache(s, self.kv_blocks, self.block_size, kv_dtype, device=dev)
            if paged else model.empty_slot_cache(s, kv_dtype, device=dev)
        )
        self._last_tok = torch.zeros(s, dtype=torch.int32, device=dev)
        self._emitted = torch.zeros(s, dtype=torch.int32, device=dev)
        self._budget = torch.zeros(s, dtype=torch.int32, device=dev)
        self._finished = torch.ones(s, dtype=torch.bool, device=dev)
        self._greedy = torch.ones(s, dtype=torch.bool, device=dev)
        self._temp = torch.ones(s, dtype=torch.float32, device=dev)
        self._top_p = torch.ones(s, dtype=torch.float32, device=dev)
        self._eos = torch.full((s,), -1, dtype=torch.int32, device=dev)

    def _refuse_unsupported(self, model, engine, slots, paged, block_size, spec_draft,
                            kv_dtype):
        """Raise at construction, as the JAX server does (``serve.py``
        :419-432), for a model or shape that a kernel this server launches
        on the card does not take: the decode step (B6, or B5 for
        "fused-layer") at ``slots`` rows, and the verify (B7, "fused" with
        ``spec_draft``) at ``spec_draft + 1`` rows a slot, over a
        ``kv_dtype`` cache."""
        nsm = torch.cuda.get_device_properties(self.device).multi_processor_count
        limit = coop_constants(self.device, model.compute_dtype)["smem_limit"]
        kw = dict(slots=slots, block_size=block_size if paged else None, kv_dtype=kv_dtype,
                  nsm=nsm, smem_limit=limit)
        checks = [("the decode step", 1)]
        if spec_draft and engine == "fused":
            checks.append((f"the verify of {spec_draft + 1} rows a slot", spec_draft + 1))
        for what, rows in checks:
            why = model._decode_unsupported_reason(rows=rows, **kw)
            if why is not None:
                raise ValueError(f"decode engine {engine!r} cannot serve this model on the card "
                                 f"({what}, {slots} slots): {why}")

    # -- the pick ----------------------------------------------------------

    def _pick(self, logits, greedy, temp, top_p, gens):
        """Per-slot next token: greedy rows take the argmax of the raw
        logits; sampled rows (those with a generator in ``gens``) take
        f32 logits/temperature, keep the nucleus by EXCLUSIVE cumulative
        probability (``cumsum - p < top_p``), and draw by Gumbel-max with
        their own generator. A bank with no sampled row skips the
        sort/softmax machinery entirely."""
        amax = torch.argmax(logits, dim=-1).to(torch.int32)
        rows = [i for i, g in enumerate(gens) if g is not None]
        if not rows:
            return amax
        lt = logits.float() / temp[:, None]
        sorted_l, order = torch.sort(lt, dim=-1, descending=True)
        probs = torch.softmax(sorted_l, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        lt = lt.masked_fill(~keep, float("-inf"))
        u = torch.zeros_like(lt)
        for i in rows:
            u[i] = torch.rand(lt.shape[-1], generator=gens[i], device=lt.device)
        gumbel = -torch.log(-torch.log(u))
        sampled = torch.argmax(lt + gumbel, dim=-1).to(torch.int32)
        return torch.where(greedy, amax, sampled)

    def _slot_gens(self):
        return [None if r is None else r.gen for r in self._slot_req]

    # -- the scheduler -----------------------------------------------------

    def submit(self, tokens, config: GenerationConfig | None = None) -> int:
        """Queue one request (a 1-D int token prompt); returns its id. The
        prompt must fit a bucket, ``len + max_new`` must fit ``max_len``
        (a slot's whole memory), and with the paged cache its blocks must
        fit the pool."""
        config = config or GenerationConfig()
        config.validate(self.model.vocab_size)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("empty prompt")
        if tokens.size > self.buckets[-1]:
            raise ValueError(
                f"prompt length {tokens.size} exceeds the largest bucket "
                f"{self.buckets[-1]}"
            )
        if tokens.size + config.max_new > self.model.max_len:
            raise ValueError(
                f"prompt {tokens.size} + max_new {config.max_new} exceeds "
                f"max_len {self.model.max_len}"
            )
        if self.paged:
            need = blocks_for(tokens.size + config.max_new, self.block_size)
            if need > self.kv_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self.kv_blocks}; raise kv_blocks or shrink the request"
                )
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, tokens, config)
        self._queue.append(req)
        self._results[rid] = req
        return rid

    def bucket_for(self, length: int) -> int:
        """Smallest bucket holding a ``length``-token prompt."""
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket {self.buckets[-1]}"
        )

    def _member_rows(self, lb, members):
        """Per-member host rows of one prefill dispatch (shared by both
        engines, so a config field reaches both): the token block and the
        sampling/budget rows, each [S]."""
        s = self.slots
        rows = dict(
            tokens=np.zeros((s, lb), np.int32), admit=np.zeros((s,), bool),
            budget=np.zeros((s,), np.int32), greedy=np.ones((s,), bool),
            temp=np.ones((s,), np.float32), top_p=np.ones((s,), np.float32),
            eos=np.full((s,), -1, np.int32),
        )
        gens = [None] * s
        for slot, req, toks in members:
            c = req.config
            rows["tokens"][slot, : toks.size] = toks
            rows["admit"][slot] = True
            rows["budget"][slot] = c.max_new
            rows["greedy"][slot] = c.greedy
            rows["temp"][slot] = c.temperature
            rows["top_p"][slot] = c.top_p
            rows["eos"][slot] = -1 if c.eos_id is None else c.eos_id
            if not c.greedy:
                req.gen = torch.Generator(device=self.device).manual_seed(c.seed)
                gens[slot] = req.gen
            self._slot_req[slot] = req
        return {k: torch.from_numpy(v).to(self.device) for k, v in rows.items()}, gens

    def _record_first(self, members, first, fin, t0) -> None:
        """Post-prefill bookkeeping of both engines: TTFT, the first token,
        an early EOS/budget finish."""
        t_first = time.perf_counter()
        self.timing["prefill_s"] += t_first - t0
        for slot, req, _ in members:
            req.t_first = t_first
            req.out.append(int(first[slot]))
            if fin[slot]:
                self._finish(slot)

    @torch.no_grad()
    def _admit_slab(self) -> None:
        """Move queued requests into free slots: one prefill dispatch per
        length bucket among this round's admissions."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        batch = []
        while free and self._queue:
            batch.append((free.pop(0), self._queue.popleft()))
        by_bucket: dict[int, list] = {}
        for slot, req in batch:
            by_bucket.setdefault(self.bucket_for(req.tokens.size), []).append(
                (slot, req, req.tokens)
            )
        for lb, members in sorted(by_bucket.items()):
            rows, gens = self._member_rows(lb, members)
            plens = np.ones((self.slots,), np.int32)  # kv_lens must be >= 1
            for slot, req, _ in members:
                plens[slot] = req.tokens.size
            t0 = time.perf_counter()
            logits, self._cache = self.model.prefill_slots(
                self.params, self._cache, rows["tokens"],
                torch.from_numpy(plens).to(self.device), rows["admit"],
            )
            first, fin = self._first_pick(logits, rows, gens)
            self._record_first(members, first, fin, t0)

    def _plan_admission(self, req: _Request):
        """Block reservation for one request: prefix-cache match (matched
        blocks retained at once, so this round's evictions cannot free
        them), worst-case new blocks for ``prompt + max_new``, LRU eviction
        of cache-only blocks when that makes the request fit. None (retains
        released) when it does not fit now."""
        total = blocks_for(int(req.tokens.size) + req.config.max_new, self.block_size)
        matched: list[int] = []
        if self._prefix is not None:
            matched = self._prefix.match(req.tokens)
            for b in matched:
                self._alloc.retain(b)
        n_new = total - len(matched)
        if not self._alloc.can_alloc(n_new) and self._prefix is not None:
            deficit = n_new - self._alloc.free_blocks
            if self._prefix.evictable_blocks() >= deficit:
                self._prefix.evict(deficit)
        if not self._alloc.can_alloc(n_new):
            for b in matched:
                self._alloc.release(b)
            return None
        return {"table": matched + self._alloc.alloc(n_new), "matched": len(matched)}

    def _admit_paged(self) -> None:
        """Admission by free BLOCKS with no head-of-line blocking: a request
        the pool cannot hold yet waits without starving those behind it.
        Planned full prompt blocks enter the radix now; a member whose
        matched blocks this round writes lands one wave past its writer,
        and waves prefill in order."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        if not free or not self._queue:
            return
        batch = []
        skipped: deque[_Request] = deque()
        pending: dict[int, int] = {}  # block id -> the wave that writes it
        bs = self.block_size
        while free and self._queue:
            req = self._queue.popleft()
            plan = self._plan_admission(req)
            if plan is None:
                skipped.append(req)
                continue
            wave = 0
            if self._prefix is not None:
                deps = [pending[b] for b in plan["table"][: plan["matched"]] if b in pending]
                if deps:
                    wave = max(deps) + 1
                n_full = int(req.tokens.size) // bs
                self._prefix.insert(req.tokens, plan["table"], n_full)
                for b in plan["table"][plan["matched"]: n_full]:
                    pending[b] = wave
            batch.append((free.pop(0), req, plan, wave))
        skipped.extend(self._queue)
        self._queue = skipped
        for slot, _, plan, _ in batch:
            row = self._host_tables[slot]
            row[:] = 0
            row[: len(plan["table"])] = plan["table"]
            self._slot_blocks[slot] = list(plan["table"])
        if batch:
            self._cache = self._cache._replace(
                block_tables=torch.from_numpy(self._host_tables).to(self.device)
            )
        for wave in sorted({m[3] for m in batch}):
            self._prefill_wave([m for m in batch if m[3] == wave])
        self.counters["kv_blocks_used"] = self._alloc.used_blocks

    @torch.no_grad()
    def _prefill_wave(self, members_w) -> None:
        """One admission wave's prefill dispatches, one per suffix bucket:
        prefix-cache hits prefill only the suffix past their cached
        blocks."""
        by_bucket: dict[int, list] = {}
        for slot, req, plan, _ in members_w:
            prefix_len = plan["matched"] * self.block_size
            suffix = req.tokens[prefix_len:]
            by_bucket.setdefault(self.bucket_for(suffix.size), []).append(
                (slot, req, suffix, prefix_len, plan["matched"])
            )
        s = self.slots
        for lb, group in sorted(by_bucket.items()):
            members = [(slot, req, suffix) for slot, req, suffix, _, _ in group]
            rows, gens = self._member_rows(lb, members)
            slens = np.ones((s,), np.int32)  # suffix lengths must be >= 1
            plens = np.zeros((s,), np.int32)
            for slot, req, suffix, prefix_len, matched in group:
                slens[slot] = suffix.size
                plens[slot] = prefix_len
                if self._prefix is not None:
                    self.counters["prefix_cache_hits"] += matched
                    self.counters["prefix_cache_misses"] += (
                        self._prefix.matchable_blocks(int(req.tokens.size)) - matched
                    )
            t0 = time.perf_counter()
            slens_t = torch.from_numpy(slens).to(self.device)
            plens_t = torch.from_numpy(plens).to(self.device)
            logits, self._cache = self.model.extend_paged(
                self.params, self._cache, rows["tokens"], slens_t, plens_t, rows["admit"]
            )
            last = logits[torch.arange(s, device=self.device), (slens_t - 1).long()]
            self._cache = self._cache._replace(lengths=torch.where(
                rows["admit"], (plens_t + slens_t).to(torch.int32), self._cache.lengths))
            first, fin = self._first_pick(last, rows, gens)
            self._record_first(members, first, fin, t0)

    @torch.no_grad()
    def _first_pick(self, logits, rows, gens):
        """Each admitted request's first pick from its prefill logits and
        its rows written into the device state. Returns the first tokens
        and finished flags as numpy (the round's one fetch)."""
        admit = rows["admit"]
        first = self._pick(logits, rows["greedy"], rows["temp"], rows["top_p"], gens)
        sel = lambda n, o: torch.where(admit, n, o)  # noqa: E731
        self._eos = sel(rows["eos"], self._eos)
        self._finished = sel((first == self._eos) | (rows["budget"] <= 1), self._finished)
        self._last_tok = sel(first, self._last_tok)
        self._emitted = sel(torch.ones_like(self._emitted), self._emitted)
        self._budget = sel(rows["budget"], self._budget)
        self._greedy = sel(rows["greedy"], self._greedy)
        self._temp = sel(rows["temp"], self._temp)
        self._top_p = sel(rows["top_p"], self._top_p)
        host = torch.stack([self._last_tok, self._finished.to(torch.int32)]).cpu()
        return host[0].numpy(), host[1].numpy().astype(bool)

    @torch.no_grad()
    def _decode_chunk(self):
        """``chunk`` decode steps on the device: every unfinished slot
        advances one token per step (decode + pick), finished and vacant
        slots ride along masked. Returns the [chunk, S] tokens, their
        validity and the finished flags, fetched in ONE transfer."""
        max_len = self.model.max_len
        decode = self.model.decode_paged if self.paged else self.model.decode_slots
        gens = self._slot_gens()
        toks, valid = [], []
        for _ in range(self.chunk):
            act = ~self._finished & (self._cache.lengths < max_len)
            logits, self._cache = decode(
                self.params, self._last_tok, self._cache, act, engine=self.decode_engine
            )
            nxt = self._pick(logits, self._greedy, self._temp, self._top_p, gens)
            nxt = torch.where(act, nxt, self._last_tok)
            self._emitted = self._emitted + act.to(torch.int32)
            self._finished = self._finished | (
                act
                & (
                    (nxt == self._eos)
                    | (self._emitted >= self._budget)
                    | (self._cache.lengths >= max_len)
                )
            )
            self._last_tok = nxt
            toks.append(nxt)
            valid.append(act.to(torch.int32))
        host = torch.cat(
            [torch.stack(toks), torch.stack(valid), self._finished[None].to(torch.int32)]
        ).cpu().numpy()
        c = self.chunk
        return host[:c], host[c:2 * c].astype(bool), host[2 * c].astype(bool)

    @torch.no_grad()
    def _verify(self, suffix, slens):
        """One speculative verify on the device: ``suffix`` [S, D+1] =
        [last_tok, d_1..d_k] per slot (``slens`` = 1 + k). ONE verify pass
        scores every position; target ``tgt[i] = argmax(logits[i])``
        (position 0 through :meth:`_pick`, so sampled slots keep their
        generator chain); draft ``d_i`` is accepted iff it equals
        ``tgt[i-1]`` and every earlier draft was; the emitted run is
        ``tgt[0..n_acc]``, cut at EOS and at the budget. ``lengths``
        advance by the tokens emitted only: rejected drafts' K/V stay past
        them, unreachable. Returns tokens and validity [D+1, S] and the
        finished flags, in one fetch."""
        st_len = self._cache.lengths
        act = ~self._finished & (st_len < self.model.max_len)
        logits, self._cache = self.model.verify_paged(
            self.params, self._cache, suffix, slens, st_len, act, engine=self.decode_engine
        )
        d1 = suffix.shape[1]
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)  # [S, D+1]
        tgt[:, 0] = self._pick(logits[:, 0], self._greedy, self._temp, self._top_p,
                               self._slot_gens())
        pos = torch.arange(d1, device=suffix.device)
        ok = (suffix[:, 1:] == tgt[:, :-1]) & (pos[None, 1:] < slens[:, None])
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(1)
        eos_hit = tgt == self._eos[:, None]
        hits = eos_hit.to(torch.int32)
        prev_eos = (torch.cumsum(hits, dim=1) - hits) > 0
        valid = (
            act[:, None]
            & (pos[None] <= n_acc[:, None])
            & (pos[None] < (self._budget - self._emitted)[:, None])
            & ~prev_eos
        )
        n_emit = valid.sum(1).to(torch.int32)
        self._emitted = self._emitted + n_emit
        last = tgt.gather(1, (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
        self._finished = self._finished | (
            act & ((eos_hit & valid).any(1) | (self._emitted >= self._budget))
        )
        self._cache = self._cache._replace(lengths=st_len + n_emit)
        self._last_tok = torch.where(act, last, self._last_tok)
        host = torch.cat(
            [tgt.T, valid.T.to(torch.int32), self._finished[None].to(torch.int32)]
        ).cpu().numpy()
        return host[:d1], host[d1:2 * d1].astype(bool), host[2 * d1].astype(bool)

    def _spec_dispatch(self):
        """One speculative tick: host prompt-lookup drafts per GREEDY slot
        over its prompt + stream, then one verify. The draft is capped at
        the remaining budget MINUS ONE: a verify emits at most
        ``accepted + 1`` tokens, so a longer draft could never be consumed,
        and its writes would pass the blocks reserved at admission (table
        entries past them are 0, another slot's block)."""
        s, d1 = self.slots, self.spec_draft + 1
        suffix = np.zeros((s, d1), np.int32)
        slens = np.ones((s,), np.int32)
        proposed = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            suffix[slot, 0] = req.out[-1]
            if req.config.greedy:
                cap = min(self.spec_draft, req.config.max_new - len(req.out) - 1)
                if cap <= 0:
                    continue  # last budgeted token: drafting is wasted work
                ctx = np.concatenate([req.tokens, np.asarray(req.out, np.int32)])
                d = lookup_draft(ctx, cap, self.spec_ngram)
                if d:
                    suffix[slot, 1: 1 + len(d)] = d
                    slens[slot] = 1 + len(d)
                    proposed += len(d)
        toks, valid, fin = self._verify(
            torch.from_numpy(suffix).to(self.device), torch.from_numpy(slens).to(self.device)
        )
        occupied = sum(r is not None for r in self._slot_req)
        self.counters["spec_tokens_proposed"] += proposed
        self.counters["spec_tokens_accepted"] += int(valid.sum()) - occupied
        return toks, valid, fin

    def _release_slot(self, slot: int) -> None:
        """Return a slot and, paged, its block references; prefix-cached
        blocks keep the radix's reference and stay resident for hits."""
        self._slot_req[slot] = None
        if self.paged and self._slot_blocks[slot] is not None:
            for b in self._slot_blocks[slot]:
                self._alloc.release(b)
            self._slot_blocks[slot] = None
            self.counters["kv_blocks_used"] = self._alloc.used_blocks

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        req.done = True
        self._release_slot(slot)
        now = time.perf_counter()
        self.stats[req.rid] = {
            "ttft_s": req.t_first - req.t_submit,
            "latency_s": now - req.t_submit,
            "tokens": len(req.out),
        }

    def step(self) -> bool:
        """One engine tick: admit queued requests (per-bucket prefill
        dispatches), then — if any slot is mid-generation — one
        ``chunk``-step decode, or with ``spec_draft`` and a greedy resident
        one speculative verify, then free the finished slots. Returns True
        while work remains."""
        if self.paged:
            self._admit_paged()
        else:
            self._admit_slab()
        if any(r is not None for r in self._slot_req):
            # Sampled slots ride verifies at draft 0 (one token each), so an
            # all-sampled tick keeps the chunk loop's amortization.
            spec = self.spec_draft and any(
                r is not None and r.config.greedy for r in self._slot_req
            )
            t0 = time.perf_counter()
            if spec:
                toks, valid, fin = self._spec_dispatch()
                self.timing["verify_s"] += time.perf_counter() - t0
                self.timing["verify_ticks"] += 1
                self.timing["verify_tokens"] += int(valid.sum())
            else:
                toks, valid, fin = self._decode_chunk()
                self.timing["decode_s"] += time.perf_counter() - t0
                self.timing["decode_steps"] += self.chunk
                self.timing["decode_tokens"] += int(valid.sum())
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                req.out.extend(int(t) for t in toks[valid[:, slot], slot])
                if fin[slot]:
                    self._finish(slot)
        return not self.idle()

    def idle(self) -> bool:
        return not self._queue and all(r is None for r in self._slot_req)

    def done(self, rid: int) -> bool:
        return self._results[rid].done

    def result(self, rid: int) -> np.ndarray:
        """Generated tokens of a finished request (prompt excluded). Consumes
        the record: a second read raises."""
        req = self._results[rid]
        if not req.done:
            raise RuntimeError(f"request {rid} is not finished")
        del self._results[rid]
        return np.asarray(req.out, np.int32)

    def generate(self, prompts, configs=None) -> list[np.ndarray]:
        """Serve a batch of token prompts to completion; returns each
        request's generated tokens in submission order."""
        if configs is None or isinstance(configs, GenerationConfig):
            configs = [configs] * len(prompts)
        rids = [self.submit(p, c) for p, c in zip(prompts, configs, strict=True)]
        while self.step():
            pass
        return [self.result(r) for r in rids]

    def serve_text(self, texts: list[str], **gen_kwargs) -> list[str]:
        """Text in → text out with the attached tokenizer; requests stop at
        its EOS id unless told otherwise."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached")
        gen_kwargs.setdefault("eos_id", self.tokenizer.eos_id)
        cfg = GenerationConfig(**gen_kwargs)
        prompts = [self.tokenizer.encode(t) for t in texts]
        return self.tokenizer.decode_batch(self.generate(prompts, cfg))
