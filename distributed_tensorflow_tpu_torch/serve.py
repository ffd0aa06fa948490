"""Batched LM serving over slots: bucketed prefill, chunked decode, continuous
batching — the slab engine of ``distributed_tensorflow_tpu/serve.py``
``TextServer``, in PyTorch.

Ported: ``GenerationConfig`` (:76), the bucket defaults (:550-559) and
``bucket_for``, ``submit``, ``_admit_slab`` (:1723), ``step`` (:1981),
``result``, ``generate`` and ``serve_text``, the chunk loop (:902-949)
and ``_pick`` (:681-713).

- **Bucketed prefill**: prompts pad to a few length buckets and prefill
  batched across the slots with ragged ``kv_lens`` masking
  (``GPTLM.prefill_slots``); on the card its attention is the flash kernel.
- **Chunked decode**: ``chunk`` single-token steps run as a Python loop on
  the device (the megakernel per step, the pick in-graph on tensors);
  tokens and validity stay on the device and come back in ONE host fetch
  per chunk — no per-token ``.item()``.
- **Continuous batching**: queued requests fill freed slots at chunk
  boundaries; each slot is an independent request at its own position.

Sampling uses one ``torch.Generator`` per request, seeded from
``GenerationConfig.seed`` and advanced only by that request's own draws,
so a sampled stream depends on its seed alone, not on what shares the
batch. (The bits differ from JAX's PRNG, so sampled streams are never
compared with the JAX package.) Greedy streams equal in-process greedy
decoding token for token.

Waiting for later slices: the paged cache and prefix cache, speculation,
quantized KV and weights, deadlines and shedding, weight swap, drain, the
event journal, metrics and their exporter.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, GPTLMParams, map_params

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
    ``chunk``-step decode) until :meth:`idle`. Runs on ``cuda`` unless
    ``device="cpu"`` is passed; without a CUDA device construction raises."""

    def __init__(
        self,
        model: GPTLM,
        params: GPTLMParams,
        tokenizer=None,
        *,
        slots: int = 8,
        buckets: tuple[int, ...] | None = None,
        chunk: int = 32,
        decode_engine: str | None = None,
        device=None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        self.model = model
        model._resolve_decode_engine(decode_engine)  # unknown names raise here
        self.decode_engine = decode_engine
        self.params = model.serving_params(
            map_params(params, lambda t: t.to(self.device))
        )
        self.tokenizer = tokenizer
        self.slots = slots
        self.chunk = chunk
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
                       "decode_tokens": 0}
        # Per finished request: ttft_s, latency_s, tokens (for reports).
        self.stats: dict[int, dict] = {}
        dev, s = self.device, slots
        self._cache = model.empty_slot_cache(s, device=dev)
        self._last_tok = torch.zeros(s, dtype=torch.int32, device=dev)
        self._emitted = torch.zeros(s, dtype=torch.int32, device=dev)
        self._budget = torch.zeros(s, dtype=torch.int32, device=dev)
        self._finished = torch.ones(s, dtype=torch.bool, device=dev)
        self._greedy = torch.ones(s, dtype=torch.bool, device=dev)
        self._temp = torch.ones(s, dtype=torch.float32, device=dev)
        self._top_p = torch.ones(s, dtype=torch.float32, device=dev)
        self._eos = torch.full((s,), -1, dtype=torch.int32, device=dev)

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
        prompt must fit a bucket and ``len + max_new`` must fit
        ``max_len`` (the slot's cache is its whole memory)."""
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
                (slot, req)
            )
        s, dev = self.slots, self.device
        for lb, members in sorted(by_bucket.items()):
            tokens = np.zeros((s, lb), np.int32)
            plens = np.ones((s,), np.int32)  # kv_lens must be >= 1
            admit = np.zeros((s,), bool)
            budget = np.zeros((s,), np.int32)
            greedy = np.ones((s,), bool)
            temp = np.ones((s,), np.float32)
            top_p = np.ones((s,), np.float32)
            eos = np.full((s,), -1, np.int32)
            gens = [None] * s
            for slot, req in members:
                c = req.config
                tokens[slot, : req.tokens.size] = req.tokens
                plens[slot] = req.tokens.size
                admit[slot] = True
                budget[slot] = c.max_new
                greedy[slot] = c.greedy
                temp[slot] = c.temperature
                top_p[slot] = c.top_p
                eos[slot] = -1 if c.eos_id is None else c.eos_id
                if not c.greedy:
                    req.gen = torch.Generator(device=dev).manual_seed(c.seed)
                    gens[slot] = req.gen
                self._slot_req[slot] = req
            t0 = time.perf_counter()
            first, fin = self._prefill(
                *(torch.from_numpy(a).to(dev) for a in
                  (tokens, plens, admit, budget, greedy, temp, top_p, eos)),
                gens,
            )
            t_first = time.perf_counter()
            self.timing["prefill_s"] += t_first - t0
            for slot, req in members:
                req.t_first = t_first
                req.out.append(int(first[slot]))
                if fin[slot]:
                    self._finish(slot)

    @torch.no_grad()
    def _prefill(self, tokens, plens, admit, budget, greedy, temp, top_p, eos, gens):
        """One admission round on the device: ragged prefill into the
        admitted slots and each admitted request's first pick. Returns the
        first tokens and finished flags as numpy (the round's one fetch)."""
        logits, self._cache = self.model.prefill_slots(
            self.params, self._cache, tokens, plens, admit
        )
        first = self._pick(logits, greedy, temp, top_p, gens)
        sel = lambda n, o: torch.where(admit, n, o)  # noqa: E731
        self._eos = sel(eos, self._eos)
        self._finished = sel((first == self._eos) | (budget <= 1), self._finished)
        self._last_tok = sel(first, self._last_tok)
        self._emitted = sel(torch.ones_like(self._emitted), self._emitted)
        self._budget = sel(budget, self._budget)
        self._greedy = sel(greedy, self._greedy)
        self._temp = sel(temp, self._temp)
        self._top_p = sel(top_p, self._top_p)
        host = torch.stack([self._last_tok, self._finished.to(torch.int32)]).cpu()
        return host[0].numpy(), host[1].numpy().astype(bool)

    @torch.no_grad()
    def _decode_chunk(self):
        """``chunk`` decode steps on the device: every unfinished slot
        advances one token per step (decode + pick), finished and vacant
        slots ride along masked. Returns the [chunk, S] tokens, their
        validity and the finished flags, fetched in ONE transfer."""
        max_len = self.model.max_len
        gens = self._slot_gens()
        toks, valid = [], []
        for _ in range(self.chunk):
            act = ~self._finished & (self._cache.lengths < max_len)
            logits, self._cache = self.model.decode_slots(
                self.params, self._last_tok, self._cache, act,
                engine=self.decode_engine,
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

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        req.done = True
        self._slot_req[slot] = None
        now = time.perf_counter()
        self.stats[req.rid] = {
            "ttft_s": req.t_first - req.t_submit,
            "latency_s": now - req.t_submit,
            "tokens": len(req.out),
        }

    def step(self) -> bool:
        """One engine tick: admit queued requests into free slots (per-bucket
        prefill dispatches), then — if any slot is mid-generation — one
        ``chunk``-step decode, then free the finished slots. Returns True
        while work remains."""
        self._admit_slab()
        occupied = sum(r is not None for r in self._slot_req)
        if occupied:
            t0 = time.perf_counter()
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
