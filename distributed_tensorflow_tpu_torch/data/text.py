"""Byte-level tokenizer of the port.

A copy of ``distributed_tensorflow_tpu/data/text.py`` ``ByteTokenizer``
(:34): the port keeps its own copy instead of importing the JAX package.
BPE comes with a later slice.
"""

from __future__ import annotations

import numpy as np


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
