"""PyTorch port: the text data (``data/text.py``) against the JAX package —
BPE merges list for list, encodings and decodings bit for bit, the vocab
file across the packages, and the packed corpora and their splits."""

from __future__ import annotations

import json

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (sets torch's thread count for xdist workers)

# Repeated pairs with equal counts: the tie goes to the smallest pair.
TIES = ["abab cdcd", "cdcd abab", "xyxy", "yxyx", "aaaa", "aaa", "é€é€", ""]


def _docs(seed, n=200):
    from distributed_tensorflow_tpu_torch.data.text import synthetic_documents

    return synthetic_documents(n, seed=seed)


@pytest.mark.parametrize("merges", [0, 1, 300])
@pytest.mark.parametrize("corpus", ["synthetic", "ties"])
def test_bpe_merges_equal_jax(corpus, merges):
    from distributed_tensorflow_tpu.data import text as jt
    from distributed_tensorflow_tpu_torch.data import text as tt

    docs = _docs(3) if corpus == "synthetic" else TIES
    ours = tt._bpe_train_py(docs, merges)
    assert ours == jt._bpe_train_py(docs, merges)
    # The JAX public trainer (its native path where built) gives the same.
    assert tt.BPETokenizer.train(docs, num_merges=merges).merges == \
        jt.BPETokenizer.train(docs, num_merges=merges).merges
    assert len(ours) <= merges


def test_bpe_encode_decode_bitwise_and_round_trip():
    from distributed_tensorflow_tpu.data import text as jt
    from distributed_tensorflow_tpu_torch.data import text as tt

    merges = tt._bpe_train_py(_docs(4), 200)
    ours, theirs = tt.BPETokenizer(merges), jt.BPETokenizer(merges)
    assert ours.vocab_size == theirs.vocab_size == 257 + len(merges)
    texts = _docs(5, 20) + ["", "a", "the model ", "naïve 数据 — ✓", "\x00\xff", "gate fuse"]
    for eos in (False, True):
        for t in texts:
            a, b = ours.encode(t, eos=eos), theirs.encode(t, eos=eos)
            assert a.dtype == b.dtype == np.int32 and a.tolist() == b.tolist(), t
        batch_a, batch_b = ours.encode_batch(texts, eos=eos), theirs.encode_batch(texts, eos=eos)
        assert [x.tolist() for x in batch_a] == [x.tolist() for x in batch_b]
    for t in texts:
        ids = ours.encode(t)
        assert ours.decode(ids) == theirs.decode(ids) == t
        assert tt._bpe_encode_py(ours._ranks, t.encode()) == jt._bpe_encode_py(
            theirs._ranks, t.encode())
    # EOS and out-of-range ids are dropped; invalid UTF-8 is replaced.
    bad = [300, 256, -1, 10 ** 6, 0xC3]
    assert ours.decode(bad) == theirs.decode(bad)
    assert ours.decode_batch([bad, [104, 105]]) == theirs.decode_batch([bad, [104, 105]])
    assert tt._merge_pair([1, 2, 1, 2, 2], (1, 2), 300) == jt._merge_pair(
        [1, 2, 1, 2, 2], (1, 2), 300)


def test_vocab_file_crosses_between_packages(tmp_path):
    from distributed_tensorflow_tpu.data import text as jt
    from distributed_tensorflow_tpu_torch.data import text as tt

    merges = tt._bpe_train_py(_docs(6), 50)
    tt.BPETokenizer(merges).save(str(tmp_path / "ours.json"))
    jt.BPETokenizer(merges).save(str(tmp_path / "theirs.json"))
    assert jt.BPETokenizer.load(str(tmp_path / "ours.json")).merges == merges
    assert tt.BPETokenizer.load(str(tmp_path / "theirs.json")).merges == merges
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    (tmp_path / "bad.json").write_text(json.dumps({"format": "other", "merges": []}))
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="dtf-bpe-v1"):
            mod.BPETokenizer.load(str(tmp_path / "bad.json"))


def test_synthetic_documents_and_packing_bitwise():
    from distributed_tensorflow_tpu.data import text as jt
    from distributed_tensorflow_tpu_torch.data import text as tt

    for kw in (dict(seed=0), dict(seed=9, min_words=2, max_words=5)):
        assert tt.synthetic_documents(50, **kw) == jt.synthetic_documents(50, **kw)
    assert tt._WORDS == jt._WORDS
    docs = _docs(7, 40)
    merges = tt._bpe_train_py(docs, 64)
    for tok_t, tok_j in ((None, None), (tt.ByteTokenizer(), jt.ByteTokenizer()),
                         (tt.BPETokenizer(merges), jt.BPETokenizer(merges))):
        a, b = tt.pack_documents(docs, 16, tok_t), jt.pack_documents(docs, 16, tok_j)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    ids = [np.arange(5), np.arange(7, 20)]
    assert np.array_equal(tt.pack_documents(ids, 4), jt.pack_documents(ids, 4))
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="shorter than one"):
            mod.pack_documents(["ab"], 64)


@pytest.mark.parametrize("bpe", [False, True], ids=["byte", "bpe"])
def test_text_corpus_bitwise(bpe):
    from distributed_tensorflow_tpu.data import text as jt
    from distributed_tensorflow_tpu_torch.data import text as tt

    merges = tt._bpe_train_py(_docs(0, 300), 128) if bpe else None
    kw = dict(num_docs=300, seq_len=32, n_val=8, n_test=8, seed=2)
    a = tt.text_corpus(**kw, tokenizer=tt.BPETokenizer(merges) if bpe else None)
    b = jt.text_corpus(**kw, tokenizer=jt.BPETokenizer(merges) if bpe else None)
    for split in ("train", "validation", "test"):
        x, y = getattr(a, split), getattr(b, split)
        assert np.array_equal(x.tokens, y.tokens) and x.lengths is y.lengths is None
        assert [x.next_indices(7).tolist() for _ in range(5)] == \
            [y.next_indices(7).tolist() for _ in range(5)]
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="packed rows"):
            mod.text_corpus(num_docs=3, seq_len=64, n_val=8, n_test=8)


def test_data_package_exports_the_text_api():
    import distributed_tensorflow_tpu_torch.data as data
    from distributed_tensorflow_tpu_torch.data import text

    for name in ("BPETokenizer", "ByteTokenizer", "pack_documents", "synthetic_documents",
                 "text_corpus"):
        assert getattr(data, name) is getattr(text, name)


def test_text_lm_example_runs_on_the_cpu():
    """``python -m distributed_tensorflow_tpu_torch.examples.text_lm`` at one
    epoch with a 64-merge BPE vocabulary: the perplexity below uniform and
    three decoded continuations of the prompt."""
    from distributed_tensorflow_tpu_torch.examples.text_lm import main

    lines = []
    res = main(epochs=1, max_new=8, bpe_merges=64, device="cpu", print_fn=lines.append)
    assert res["vocab_size"] == 321 and res["perplexity"] < res["vocab_size"]
    assert set(res["texts"]) == {"greedy", "nucleus", "beam-4"}
    assert all(t.startswith("the model ") for t in res["texts"].values())
    assert lines[0].startswith("trained 64-merge BPE vocab") and lines[-1] == "Done"
