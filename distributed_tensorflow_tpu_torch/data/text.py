"""Text → token pipeline of the LM family: the byte-level tokenizer,
byte-level BPE, EOS document packing and a deterministic text corpus.

A copy of ``distributed_tensorflow_tpu/data/text.py``: ``ByteTokenizer``
(:34), ``BPETokenizer`` (:61) with the ``dtf-bpe-v1`` vocab file,
``_merge_pair`` (:187), ``_bpe_train_py`` (:203), ``_bpe_encode_py``
(:314), ``pack_documents`` (:358), ``synthetic_documents`` (:401) and
``text_corpus`` (:423). The port keeps its own copy instead of importing
the JAX package; the merges, encodings and packed corpora are bitwise the
JAX package's (``tests/test_torch_text.py``).

BPE runs on the pure-Python path only. The JAX package's native fast path
(``runtime/native.py`` over ``runtime/csrc/dtf_runtime.cc``) is
bit-identical to it and comes with the port's own copy of that runtime
(ROADMAP A8c, which needs it for the heartbeat and ``crc32c``).
"""

from __future__ import annotations

import heapq
import json
import os

import numpy as np

from distributed_tensorflow_tpu_torch.data.tokens import TokenDatasets, _split


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are the bytes, ``eos_id`` (=256)
    terminates documents; build the LM with ``vocab_size`` (=257).
    Round-trip exact for every string; ``decode`` drops EOS and any
    out-of-range id and replaces invalid UTF-8."""

    eos_id: int = 256
    vocab_size: int = 257

    def encode(self, text: str, *, eos: bool = False) -> np.ndarray:
        ids = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)
        if eos:
            ids = np.concatenate([ids, np.array([self.eos_id], np.int32)])
        return ids

    def decode(self, ids) -> str:
        arr = np.asarray(ids).reshape(-1)
        arr = arr[(arr >= 0) & (arr < 256)]
        return arr.astype(np.uint8).tobytes().decode("utf-8", errors="replace")

    def decode_batch(self, batches) -> list[str]:
        return [self.decode(ids) for ids in batches]


class BPETokenizer:
    """Byte-level BPE trained on a corpus: ids 0..255 are bytes, 256 is
    EOS, 257.. are learned merges (GPT-2's scheme minus the regex
    pre-tokenizer — merges run over the raw byte stream, which keeps the
    implementation exact and dependency-free). Deterministic training
    (ties broken by smallest pair) and exact round-trip for ANY string —
    unseen bytes simply stay unmerged (the byte fallback real BPE vocabs
    rely on).

    ``BPETokenizer.train(docs, num_merges=K)`` learns K merges; build the
    LM with ``vocab_size=tok.vocab_size`` (= 257 + K). ``encode`` applies
    merges in rank order (lowest rank first, all occurrences left to
    right); ``decode`` expands each id back to its bytes.

    Training maintains pair counts *incrementally* over a linked-list
    corpus — O(total merge operations), not O(num_merges × corpus) — and
    ``encode`` is a single heap pass, O(n log n) in the input length.
    ``save``/``load`` round-trip the learned merges as JSON (the
    ``dtf-bpe-v1`` format of the JAX package, so a vocab file crosses
    between the packages)."""

    eos_id: int = 256

    def __init__(self, merges: list[tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self._ranks = {pair: i for i, pair in enumerate(self.merges)}
        # id → bytes expansion table.
        table = [bytes([i]) for i in range(256)] + [b""]  # EOS → empty
        for a, b in self.merges:
            table.append(table[a] + table[b])
        self._bytes = table
        self.vocab_size = len(table)

    @classmethod
    def train(cls, docs: list[str], *, num_merges: int) -> "BPETokenizer":
        return cls(_bpe_train_py(docs, num_merges))

    def encode(self, text: str, *, eos: bool = False) -> np.ndarray:
        data = text.encode("utf-8")
        if len(data) > 1 and self._ranks:
            ids = _bpe_encode_py(self._ranks, data)
        else:
            ids = list(data)
        if eos:
            ids = ids + [self.eos_id]
        return np.asarray(ids, np.int32)

    def encode_batch(
        self, texts: list[str], *, eos: bool = False
    ) -> list[np.ndarray]:
        """Encode many documents at once (``eos`` appends EOS to each)."""
        pieces = [
            np.asarray(_bpe_encode_py(self._ranks, t.encode("utf-8")), np.int32)
            for t in texts
        ]
        if eos:
            tail = np.array([self.eos_id], np.int32)
            pieces = [np.concatenate([p, tail]) for p in pieces]
        return [np.asarray(p, np.int32) for p in pieces]

    def decode(self, ids) -> str:
        arr = np.asarray(ids).reshape(-1)
        out = b"".join(
            self._bytes[i] for i in arr if 0 <= i < self.vocab_size
        )
        return out.decode("utf-8", errors="replace")

    def decode_batch(self, batches) -> list[str]:
        """Decode many id sequences (inverse of :meth:`encode_batch` for
        any round-trippable input; the serving layer's read half)."""
        return [self.decode(ids) for ids in batches]

    # -- serialization (the vocab file that ships with a checkpoint) ------

    def save(self, path: str) -> None:
        """Write the learned merges as JSON (atomic rename so a reader
        never sees a partial vocab file)."""
        payload = {"format": "dtf-bpe-v1", "merges": [list(m) for m in self.merges]}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != "dtf-bpe-v1":
            raise ValueError(
                f"not a dtf-bpe-v1 vocab file: {path!r} "
                f"(format={payload.get('format')!r})"
            )
        return cls([(int(a), int(b)) for a, b in payload["merges"]])


def _merge_pair(ids, pair, new_id):
    """One BPE merge pass: every non-overlapping occurrence of ``pair``
    (left to right) becomes ``new_id``."""
    out = []
    i = 0
    n = len(ids)
    while i < n:
        if i + 1 < n and ids[i] == pair[0] and ids[i + 1] == pair[1]:
            out.append(new_id)
            i += 2
        else:
            out.append(int(ids[i]))
            i += 1
    return out


def _bpe_train_py(docs: list[str], num_merges: int) -> list[tuple[int, int]]:
    """Incremental BPE training over a linked-list corpus.

    Semantics are exactly the naive recount-per-round algorithm (pick the
    most frequent adjacent pair, ties to the smallest pair; merge every
    non-overlapping occurrence left to right; never merge across document
    boundaries) — but pair counts are maintained by ±deltas at each merge
    site instead of a full corpus rescan per round, and selection is a
    lazy max-heap. Total work is O(corpus + Σ merge-site updates)."""
    blobs = [np.frombuffer(d.encode("utf-8"), np.uint8) for d in docs]
    total = int(sum(len(s) for s in blobs))
    ids = np.empty(total, np.int32)
    nxt = np.full(total, -1, np.int64)
    prv = np.full(total, -1, np.int64)
    off = 0
    for s in blobs:
        n = len(s)
        if n == 0:
            continue
        ids[off : off + n] = s
        nxt[off : off + n - 1] = np.arange(off + 1, off + n)
        prv[off + 1 : off + n] = np.arange(off, off + n - 1)
        off += n

    # Initial counts + occurrence lists in one vectorized pass: positions
    # grouped per pair, ascending (stable argsort of the position-ordered
    # code vector).
    left = np.nonzero(nxt >= 0)[0]
    counts: dict[tuple[int, int], int] = {}
    occ0: dict[tuple[int, int], np.ndarray] = {}
    occ_new: dict[tuple[int, int], list[int]] = {}
    if len(left):
        codes = (ids[left].astype(np.int64) << 32) | ids[left + 1]
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        uniq, starts = np.unique(sorted_codes, return_index=True)
        bounds = np.append(starts, len(sorted_codes))
        for k in range(len(uniq)):
            pair = (int(uniq[k] >> 32), int(uniq[k] & 0xFFFFFFFF))
            counts[pair] = int(bounds[k + 1] - bounds[k])
            occ0[pair] = left[order[bounds[k] : bounds[k + 1]]]

    heap = [(-c, pair) for pair, c in counts.items()]
    heapq.heapify(heap)

    merges: list[tuple[int, int]] = []
    while len(merges) < num_merges and heap:
        negc, pair = heap[0]
        c = counts.get(pair)
        if c is None or -negc != c:
            heapq.heappop(heap)  # stale entry
            continue
        heapq.heappop(heap)
        new_id = 257 + len(merges)
        merges.append(pair)
        a, b = pair
        parts = []
        if pair in occ0:
            parts.append(occ0.pop(pair))
        if pair in occ_new:
            parts.append(np.asarray(occ_new.pop(pair), np.int64))
        positions = np.sort(np.concatenate(parts)) if parts else ()
        # Count deltas accumulate per ROUND and apply once per distinct
        # changed pair (one heap push each) — per-occurrence pushes drown
        # the heap in stale entries on repetitive corpora.
        delta: dict[tuple[int, int], int] = {}
        for i in positions:
            i = int(i)
            if ids[i] != a:
                continue  # stale occurrence (node merged/killed since)
            j = int(nxt[i])
            if j < 0 or ids[j] != b:
                continue
            p = int(prv[i])
            q = int(nxt[j])
            # Read neighbor ids BEFORE rewriting the nodes (overlap chains
            # like [a,a,a] with pair (a,a) depend on it).
            if p >= 0:
                k = (int(ids[p]), a)
                delta[k] = delta.get(k, 0) - 1
            if q >= 0:
                k = (b, int(ids[q]))
                delta[k] = delta.get(k, 0) - 1
            ids[i] = new_id
            ids[j] = -2  # dead node
            nxt[i] = q
            if q >= 0:
                prv[q] = i
                k = (new_id, int(ids[q]))
                delta[k] = delta.get(k, 0) + 1
                occ_new.setdefault(k, []).append(i)
            if p >= 0:
                k = (int(ids[p]), new_id)
                delta[k] = delta.get(k, 0) + 1
                occ_new.setdefault(k, []).append(p)
        for k, d in delta.items():
            if k == pair or d == 0:
                continue
            c2 = counts.get(k, 0) + d
            if c2 <= 0:
                counts.pop(k, None)
            else:
                counts[k] = c2
                heapq.heappush(heap, (-c2, k))
        counts.pop(pair, None)
    return merges


def _bpe_encode_py(
    ranks: dict[tuple[int, int], int], data: bytes
) -> list[int]:
    """Single-heap BPE encode: pop (rank, position) ascending, merge, push
    the two newly-created neighbor pairs. Equivalent to applying merges in
    rank order with all occurrences left to right (a pair created by a
    rank-r merge always has rank > r, so the heap drains rank levels in
    order), O(n log n) in the input length."""
    ids = list(data)
    n = len(ids)
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    heap = []
    for i in range(n - 1):
        r = ranks.get((ids[i], ids[i + 1]))
        if r is not None:
            heap.append((r, i))
    heapq.heapify(heap)
    while heap:
        r, i = heapq.heappop(heap)
        if ids[i] < 0:
            continue
        j = nxt[i]
        if j < 0:
            continue
        if ranks.get((ids[i], ids[j])) != r:
            continue  # stale entry
        ids[i] = 257 + r
        ids[j] = -1
        q = nxt[j]
        nxt[i] = q
        if q >= 0:
            prv[q] = i
            r2 = ranks.get((ids[i], ids[q]))
            if r2 is not None:
                heapq.heappush(heap, (r2, i))
        p = prv[i]
        if p >= 0:
            r2 = ranks.get((ids[p], ids[i]))
            if r2 is not None:
                heapq.heappush(heap, (r2, p))
    return [t for t in ids if t >= 0]


def pack_documents(
    docs: list[str] | list[np.ndarray],
    seq_len: int,
    tokenizer: "ByteTokenizer | BPETokenizer | None" = None,
) -> np.ndarray:
    """Concatenate ``doc₀ EOS doc₁ EOS ...`` and chunk the stream into
    [N, seq_len] int32 rows (the tail that doesn't fill a row is
    dropped — standard LM packing; no padding, every kept position is a
    real training target). ``docs`` may be strings (encoded with
    ``tokenizer``, default :class:`ByteTokenizer`) or pre-tokenized id
    arrays (used verbatim, EOS appended)."""
    tok = tokenizer or ByteTokenizer()
    batch_encode = getattr(tok, "encode_batch", None)
    if batch_encode is not None and docs and all(isinstance(d, str) for d in docs):
        parts = batch_encode(list(docs), eos=True)
    else:
        parts = []
        for d in docs:
            if isinstance(d, str):
                parts.append(tok.encode(d, eos=True))
            else:
                parts.append(
                    np.concatenate(
                        [np.asarray(d, np.int32), np.array([tok.eos_id], np.int32)]
                    )
                )
    stream = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
    n = len(stream) // seq_len
    if n == 0:
        raise ValueError(
            f"packed stream ({len(stream)} tokens) shorter than one "
            f"seq_len={seq_len} row"
        )
    return stream[: n * seq_len].reshape(n, seq_len).astype(np.int32)


_WORDS = (
    "the a one this that model data train step loss grad mesh chip ring "
    "token batch epoch scan shard sum small fast slow deep wide new old "
    "red blue green node host core wire pipe gate fuse"
).split()


def synthetic_documents(
    num_docs: int, *, seed: int = 0, min_words: int = 8, max_words: int = 40
) -> list[str]:
    """Deterministic English-like documents from a seeded word-Markov
    chain (first-order over a fixed 40-word vocabulary, transition rows
    drawn once from a Dirichlet). Same seed → same corpus, everywhere."""
    rng = np.random.default_rng(seed)
    w = len(_WORDS)
    trans = rng.dirichlet(np.full(w, 0.3), size=w)
    start = rng.dirichlet(np.full(w, 0.5))
    docs = []
    for _ in range(num_docs):
        length = int(rng.integers(min_words, max_words + 1))
        idx = int(rng.choice(w, p=start))
        words = [_WORDS[idx]]
        for _ in range(length - 1):
            idx = int(rng.choice(w, p=trans[idx]))
            words.append(_WORDS[idx])
        docs.append(" ".join(words) + ".")
    return docs


def text_corpus(
    *,
    num_docs: int = 512,
    seq_len: int = 128,
    n_val: int = 32,
    n_test: int = 32,
    seed: int = 0,
    tokenizer: ByteTokenizer | BPETokenizer | None = None,
) -> TokenDatasets:
    """LM corpus over :func:`synthetic_documents` — byte-level by
    default, subword with a trained :class:`BPETokenizer` — packed with
    :func:`pack_documents` and split train/validation/test contiguously
    (data/tokens.py ``_split`` — the packed rows are draws from one
    stationary chain, so contiguous splits are i.i.d.-equivalent). Build
    the model with ``vocab_size=tokenizer.vocab_size`` (257 for the
    default :class:`ByteTokenizer`; a corpus-trained BPE vocabulary packs
    the same documents into fewer tokens per document)."""
    docs = synthetic_documents(num_docs, seed=seed)
    tokens = pack_documents(docs, seq_len, tokenizer)
    if len(tokens) <= n_val + n_test:
        raise ValueError(
            f"only {len(tokens)} packed rows; need > n_val+n_test "
            f"({n_val}+{n_test}) — more docs or a smaller seq_len"
        )
    return _split(tokens, None, n_val, n_test, seed)
