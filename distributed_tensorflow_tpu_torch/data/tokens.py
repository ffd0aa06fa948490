"""Token data for the LM family: a numpy copy of
``distributed_tensorflow_tpu/data/tokens.py``.

The reference's loader contract over token sequences: a
:class:`TokenDataset` with the shuffled-permutation / tail-carry
``next_batch`` of the MNIST loader, and ``next_indices``, the index stream
behind it, so a trainer can gather on the device exactly the batches
``next_batch`` would give; :class:`TokenDatasets` groups train / validation /
test splits. Two synthetic corpora made from a seed (no download):
:func:`copy_corpus` (sequences ``x · x``; learning the copy needs
attention) and :func:`markov_corpus` (a fixed random first-order Markov
chain; held-out perplexity falls well below uniform). Every array and
index stream is bitwise the JAX package's for the same arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TokenDataset:
    """One split of token sequences with the tutorial loader's ``next_batch``
    iteration contract (shuffled permutation, tail-carry across epoch
    boundaries — no sequence ever dropped). ``lengths`` is optional [N]
    int32 for ragged (right-padded) corpora; when present, ``next_batch``
    returns (tokens, lengths) pairs."""

    def __init__(
        self,
        tokens: np.ndarray,
        lengths: np.ndarray | None = None,
        *,
        seed: int = 0,
    ):
        tokens = np.asarray(tokens, np.int32)
        assert tokens.ndim == 2, tokens.shape
        if lengths is not None:
            lengths = np.asarray(lengths, np.int32)
            assert lengths.shape == (tokens.shape[0],)
        self._tokens = tokens
        self._lengths = lengths
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(tokens.shape[0])
        self._index = 0
        self._epochs_completed = 0

    @property
    def tokens(self) -> np.ndarray:
        return self._tokens

    @property
    def lengths(self) -> np.ndarray | None:
        return self._lengths

    @property
    def num_examples(self) -> int:
        return self._tokens.shape[0]

    @property
    def seq_len(self) -> int:
        return self._tokens.shape[1]

    @property
    def epochs_completed(self) -> int:
        return self._epochs_completed

    def next_indices(self, batch_size: int) -> np.ndarray:
        """The index stream behind ``next_batch`` — exposed so a trainer
        can draw the identical batch sequence as device-side gathers (the
        LM trainer's loop; the MLP Trainer's indexed scan, train/scan.py)."""
        if self._index + batch_size > self.num_examples:
            rest = self._perm[self._index :]
            self._epochs_completed += 1
            self._perm = self._rng.permutation(self.num_examples)
            take = batch_size - rest.shape[0]
            idx = np.concatenate([rest, self._perm[:take]])
            self._index = take
        else:
            idx = self._perm[self._index : self._index + batch_size]
            self._index += batch_size
        return idx

    def next_batch(self, batch_size: int):
        idx = self.next_indices(batch_size)
        if self._lengths is None:
            return self._tokens[idx]
        return self._tokens[idx], self._lengths[idx]


class TokenDatasets(NamedTuple):
    train: TokenDataset
    validation: TokenDataset
    test: TokenDataset


def _split(tokens: np.ndarray, lengths, n_val: int, n_test: int, seed: int):
    n = tokens.shape[0]
    n_train = n - n_val - n_test
    assert n_train > 0, (n, n_val, n_test)

    def ds(lo, hi, s):
        return TokenDataset(
            tokens[lo:hi],
            None if lengths is None else lengths[lo:hi],
            seed=s,
        )

    return TokenDatasets(
        train=ds(0, n_train, seed),
        validation=ds(n_train, n_train + n_val, seed + 1),
        test=ds(n_train + n_val, n, seed + 2),
    )


def copy_corpus(
    num: int = 4096,
    half_len: int = 8,
    vocab: int = 61,
    *,
    n_val: int = 256,
    n_test: int = 256,
    seed: int = 0,
) -> TokenDatasets:
    """Sequences ``x · x`` with x uniform over the vocabulary. A model that
    learns the copy reaches mean next-token CE ≈ (H−1)/(2H−1) · log V
    (first-half targets stay at chance, copied-half targets go to ~0)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, vocab, size=(num, half_len))
    tokens = np.concatenate([half, half], axis=1).astype(np.int32)
    return _split(tokens, None, n_val, n_test, seed)


def markov_corpus(
    num: int = 4096,
    seq_len: int = 32,
    vocab: int = 32,
    *,
    concentration: float = 0.25,
    n_val: int = 256,
    n_test: int = 256,
    seed: int = 0,
) -> TokenDatasets:
    """Sequences from one fixed random first-order Markov chain (Dirichlet
    rows, low ``concentration`` → peaky transitions). Held-out perplexity of
    a trained LM approaches the chain's conditional entropy — well below
    vocab-uniform — so eval metrics have something real to measure."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab, concentration), size=vocab)
    tokens = np.empty((num, seq_len), np.int32)
    tokens[:, 0] = rng.integers(0, vocab, size=num)
    # Vectorized over the batch: one inverse-CDF draw per position.
    cdf = np.cumsum(trans, axis=1)
    for t in range(1, seq_len):
        u = rng.random(num)
        tokens[:, t] = (cdf[tokens[:, t - 1]] < u[:, None]).sum(axis=1)
    np.clip(tokens, 0, vocab - 1, out=tokens)
    return _split(tokens, None, n_val, n_test, seed)
